"""The benchmark of ``nos_tpu_torch`` on one H100: cells, metrics and the
plain reference that decides ``correct``.  See ``run.py``."""
