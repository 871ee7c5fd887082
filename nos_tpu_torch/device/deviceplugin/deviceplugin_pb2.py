# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: deviceplugin.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12\x64\x65viceplugin.proto\x12\x07v1beta1\"z\n\x0fRegisterRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x02 \x01(\t\x12\x15\n\rresource_name\x18\x03 \x01(\t\x12-\n\x07options\x18\x04 \x01(\x0b\x32\x1c.v1beta1.DevicePluginOptions\"\x07\n\x05\x45mpty\"]\n\x13\x44\x65vicePluginOptions\x12\x1a\n\x12pre_start_required\x18\x01 \x01(\x08\x12*\n\"get_preferred_allocation_available\x18\x02 \x01(\x08\"8\n\x14ListAndWatchResponse\x12 \n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x0f.v1beta1.Device\"$\n\x06\x44\x65vice\x12\n\n\x02ID\x18\x01 \x01(\t\x12\x0e\n\x06health\x18\x02 \x01(\t\"P\n\x0f\x41llocateRequest\x12=\n\x12\x63ontainer_requests\x18\x01 \x03(\x0b\x32!.v1beta1.ContainerAllocateRequest\"/\n\x18\x43ontainerAllocateRequest\x12\x13\n\x0b\x64\x65vices_IDs\x18\x01 \x03(\t\"S\n\x10\x41llocateResponse\x12?\n\x13\x63ontainer_responses\x18\x01 \x03(\x0b\x32\".v1beta1.ContainerAllocateResponse\"\x84\x01\n\x19\x43ontainerAllocateResponse\x12:\n\x04\x65nvs\x18\x01 \x03(\x0b\x32,.v1beta1.ContainerAllocateResponse.EnvsEntry\x1a+\n\tEnvsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\x46\n\x0cRegistration\x12\x36\n\x08Register\x12\x18.v1beta1.RegisterRequest\x1a\x0e.v1beta1.Empty\"\x00\x32\xde\x01\n\x0c\x44\x65vicePlugin\x12H\n\x16GetDevicePluginOptions\x12\x0e.v1beta1.Empty\x1a\x1c.v1beta1.DevicePluginOptions\"\x00\x12\x41\n\x0cListAndWatch\x12\x0e.v1beta1.Empty\x1a\x1d.v1beta1.ListAndWatchResponse\"\x00\x30\x01\x12\x41\n\x08\x41llocate\x12\x18.v1beta1.AllocateRequest\x1a\x19.v1beta1.AllocateResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'deviceplugin_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._options = None
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._serialized_options = b'8\001'
  _REGISTERREQUEST._serialized_start=31
  _REGISTERREQUEST._serialized_end=153
  _EMPTY._serialized_start=155
  _EMPTY._serialized_end=162
  _DEVICEPLUGINOPTIONS._serialized_start=164
  _DEVICEPLUGINOPTIONS._serialized_end=257
  _LISTANDWATCHRESPONSE._serialized_start=259
  _LISTANDWATCHRESPONSE._serialized_end=315
  _DEVICE._serialized_start=317
  _DEVICE._serialized_end=353
  _ALLOCATEREQUEST._serialized_start=355
  _ALLOCATEREQUEST._serialized_end=435
  _CONTAINERALLOCATEREQUEST._serialized_start=437
  _CONTAINERALLOCATEREQUEST._serialized_end=484
  _ALLOCATERESPONSE._serialized_start=486
  _ALLOCATERESPONSE._serialized_end=569
  _CONTAINERALLOCATERESPONSE._serialized_start=572
  _CONTAINERALLOCATERESPONSE._serialized_end=704
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._serialized_start=661
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._serialized_end=704
  _REGISTRATION._serialized_start=706
  _REGISTRATION._serialized_end=776
  _DEVICEPLUGIN._serialized_start=779
  _DEVICEPLUGIN._serialized_end=1001
# @@protoc_insertion_point(module_scope)
