# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: podresources.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12podresources.proto\x12\x02v1\"\x19\n\x17ListPodResourcesRequest\"C\n\x18ListPodResourcesResponse\x12\'\n\rpod_resources\x18\x01 \x03(\x0b\x32\x10.v1.PodResources\"[\n\x0cPodResources\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12*\n\ncontainers\x18\x03 \x03(\x0b\x32\x16.v1.ContainerResources\"I\n\x12\x43ontainerResources\x12\x0c\n\x04name\x18\x01 \x01(\t\x12%\n\x07\x64\x65vices\x18\x02 \x03(\x0b\x32\x14.v1.ContainerDevices\"=\n\x10\x43ontainerDevices\x12\x15\n\rresource_name\x18\x01 \x01(\t\x12\x12\n\ndevice_ids\x18\x02 \x03(\t2Y\n\x12PodResourcesLister\x12\x43\n\x04List\x12\x1b.v1.ListPodResourcesRequest\x1a\x1c.v1.ListPodResourcesResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'podresources_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LISTPODRESOURCESREQUEST._serialized_start=26
  _LISTPODRESOURCESREQUEST._serialized_end=51
  _LISTPODRESOURCESRESPONSE._serialized_start=53
  _LISTPODRESOURCESRESPONSE._serialized_end=120
  _PODRESOURCES._serialized_start=122
  _PODRESOURCES._serialized_end=213
  _CONTAINERRESOURCES._serialized_start=215
  _CONTAINERRESOURCES._serialized_end=288
  _CONTAINERDEVICES._serialized_start=290
  _CONTAINERDEVICES._serialized_end=351
  _PODRESOURCESLISTER._serialized_start=353
  _PODRESOURCESLISTER._serialized_end=442
# @@protoc_insertion_point(module_scope)
