"""The plain reference that decides ``correct``: fp32 PyTorch with TF32
off, written from the published architectures and the optimizers the
configuration files state.  It imports nothing of the program and takes
from the harness only the seeded weights and tokens (``portbench.inputs``)
and the configuration (``portbench.cells.ModelSpec``)."""
