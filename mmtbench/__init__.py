"""The benchmark of ``mmt_tpu_torch`` (see ``run.py``)."""
