"""Probe kernels for the Hopper redesign of the attention kernels.

Counterparts of the three TPU probe scripts: ``split_probe`` (the far /
structured split schedule), ``op_cost_probe`` (the cost of each op family
inside the forward kernel's grid) and ``mosaic_probe`` (the six functions
of ``scripts/mosaic_probe.py`` as batched kernels); beside them
``hopper_probe`` (does the toolchain build, and the card run right, each
primitive the redesign needs) and ``fwd_ab``.  Each is runnable on the card
as ``python -m mmt_tpu_torch.probes.<name>``.  Nothing on the retrieval or
training paths imports them.
"""
