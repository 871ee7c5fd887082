"""The program's side of a cell: ``<family>_<kind>.py`` builds the system
under test from a cell's configuration and the seeded weights and feeds
it as its main does.  Each module has ``Session(cell, seed, device)``:

- ``batches()``: the feed, one step's batch at a time, without end;
- ``step(batch)``: one step through the program's own call, returning
  the loss as a device scalar;
- ``first_grad_norms()``: right after the first step, each parameter's
  norm of the gradient as the optimizer got it, from its state;
- ``params()``: each parameter's local tensor, by the program's name;
- ``close()``: free the state and the process group.
"""
