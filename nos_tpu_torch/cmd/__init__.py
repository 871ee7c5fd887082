"""The port's mains (``python -m nos_tpu_torch.cmd.train``)."""
