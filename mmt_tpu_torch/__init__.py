"""MMT in PyTorch for NVIDIA Hopper: the port of ``mmt_tpu``.

Imports torch, numpy and the standard library only.  Relative attention
runs in hand-written CUDA kernels (``csrc/rel_attention_fwd.cu`` for the
forward with in-kernel dropout, ``csrc/rel_attention_bwd.cu`` for the
one-pass backward), built with nvcc at first use into the git-ignored
``_build/`` directory.  Retrieval inference (``eval.predict``,
``cli.predict``), WIT pretraining and ITM finetuning
(``train.tasks.PretrainingTask`` / ``ClassificationTask`` +
``train.loop.run_training``, ``cli.train``) run through them; so do the
serving extras (dynamic int8 in ``ops.quant``, ``torch.export`` scoring
artifacts and bundles in ``eval.export``).  ``preprocessing`` holds the
dataset CLIs.
"""
