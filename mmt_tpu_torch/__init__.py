"""MMT in PyTorch for NVIDIA Hopper: the port of ``mmt_tpu``.

Imports torch, numpy and the standard library only.  Relative attention
runs in hand-written CUDA kernels (``csrc/rel_attention_fwd.cu`` for the
forward with in-kernel dropout, ``csrc/rel_attention_bwd.cu`` for the
two-pass backward), built with nvcc at first use into the git-ignored
``_build/`` directory.  Retrieval inference (``eval.predict``) and WIT
pretraining (``train.tasks.PretrainingTask`` + ``train.loop.run_training``,
``cli.train``) run through them.
"""
