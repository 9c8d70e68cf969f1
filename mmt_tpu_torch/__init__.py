"""MMT in PyTorch for NVIDIA Hopper: the port of ``mmt_tpu``.

Imports torch, numpy and the standard library only.  The relative
attention forward runs in a hand-written CUDA kernel
(``csrc/rel_attention_fwd.cu``), built with nvcc at first use into the
git-ignored ``_build/`` directory.
"""
