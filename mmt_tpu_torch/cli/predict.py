"""Prediction / retrieval-eval entry point.

Counterpart of ``mmt_tpu/cli/predict.py``: build the mmt/classification
experiment, apply yaml overrides, read the ``input_meta_data`` JSON,
construct the retrieval data config (paired records or image x text
cross-product), restore the checkpoint, score all pairs, and write
``results.csv`` + ``recall.json``.

Usage:
  python -m mmt_tpu_torch.cli.predict --config_file=exp.yaml \
      --input_meta_data_path=meta.json --predict_split=test \
      --init_checkpoint=/path/ckpt --test_output_dir=/tmp/out \
      --predict_global_batch_size=2048 [--device=cpu]

``--init_checkpoint`` is a directory written by
``mmt_tpu_torch.train.checkpoint.CheckpointManager``.  The model runs on
``--device`` (default ``cuda``; without a GPU that raises, it does not
carry on on the CPU).  A yaml ``--config_file`` needs pyyaml; one written as
JSON text loads without it.

Several processes (``torchrun --nproc_per_node=N -m mmt_tpu_torch.cli.predict
...``; ``nccl`` on the card, ``gloo`` with ``--device=cpu``) split the
scoring over their ranks, as the JAX CLI shards it over its devices: the
batch is rounded up to a multiple of the number of ranks
(``mmt_tpu/cli/predict.py:100-110``; the loader pads the last batch with
``valid`` 0 rows), every rank reads every batch and scores its own rows,
and the scores are gathered in input order.  Rank 0 alone writes
``results.csv`` and ``recall.json`` (and a serving artifact), the same
bytes as one process writes.

``--export_serving_artifact=F`` restores the checkpoint, writes the scoring
computation as a ``torch.export`` artifact to F (``eval/export.py``; a
static batch of ``--predict_global_batch_size`` when the config's
``attention_impl`` is ``pallas``, a symbolic one otherwise, as in JAX) and
returns without scoring; with ``--export_bucket_sizes=1,8,32`` it writes a
bundle of one static-batch artifact per bucket instead.  The bucket list
takes spaces, empty items and a trailing comma; a non-integer or a size
below 1 is a usage error (exit 2), as is a bucket list without
``--export_serving_artifact``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging


def bucket_sizes(text: str) -> list:
    """``--export_bucket_sizes``: comma-separated ints >= 1; spaces, empty
    items and a trailing comma are ignored."""
    items = [x.strip() for x in text.split(",") if x.strip()]
    try:
        sizes = [int(x) for x in items]
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a comma-separated list of integers: {text!r}")
    if not sizes or min(sizes) < 1:
        raise argparse.ArgumentTypeError(f"bucket sizes must be integers >= 1, got {text!r}")
    return sizes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config_file", action="append", default=[])
    p.add_argument("--params_override", default="")
    p.add_argument("--input_meta_data_path", required=True)
    p.add_argument("--predict_split", default="test")
    p.add_argument("--init_checkpoint", required=True)
    p.add_argument("--test_output_dir", required=True)
    p.add_argument("--predict_global_batch_size", type=int, default=2048)
    p.add_argument(
        "--export_serving_artifact", default="",
        help="write the scoring computation as a torch.export artifact to this path "
             "and exit without scoring; see mmt_tpu_torch/eval/export.py")
    p.add_argument(
        "--export_bucket_sizes", type=bucket_sizes, default=[],
        help="comma-separated batch-size buckets (e.g. '1,8,32'): write a bundle of "
             "static-batch artifacts instead of one artifact; load it with "
             "mmt_tpu_torch.eval.export.load_scoring_bundle")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.export_bucket_sizes and not args.export_serving_artifact:
        p.error("--export_bucket_sizes needs --export_serving_artifact (the bundle's path)")
    return args


def build_retrieval_data_config(task_data_cfg, meta, split: str, batch_size: int):
    """The retrieval data config of one split of ``meta``: paired records
    when it names ``<split>_input_path``, else the image x text cross
    product."""
    from mmt_tpu_torch.configs.data import MmtRetrievalDataConfig

    common = dict(
        global_batch_size=batch_size,
        vocab_filename=task_data_cfg.vocab_filename,
        text_special_token_field_dict=task_data_cfg.text_special_token_field_dict,
        is_training=False,
        max_seq_len=meta["max_seq_length"],
        drop_remainder=False,
        include_image_text_index=True,
        relative_pos_max_distance=task_data_cfg.relative_pos_max_distance,
        relative_att_num_core_layers=task_data_cfg.relative_att_num_core_layers,
        image_size=task_data_cfg.image_size,
        patch_size=task_data_cfg.patch_size,
    )
    input_path = meta.get(f"{split}_input_path")
    if input_path is None:
        return MmtRetrievalDataConfig(
            image_input_path=meta[f"{split}_image_input_path"],
            text_input_path=meta[f"{split}_text_input_path"],
            num_image_examples=meta[f"{split}_num_image_examples"],
            num_text_examples=meta[f"{split}_num_text_examples"],
            **common,
        )
    return MmtRetrievalDataConfig(
        input_path=input_path, num_examples=meta.get(f"{split}_num_examples", 0), **common
    )


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from mmt_tpu_torch.configs import get_experiment_config
    from mmt_tpu_torch.configs.base import from_yaml_file, parse_params_override
    from mmt_tpu_torch.data.loaders import MmtRetrievalLoader
    from mmt_tpu_torch.device import resolve_device
    from mmt_tpu_torch.eval.predict import predict, sharded_inference_step, write_results
    from mmt_tpu_torch.parallel.mesh import create_mesh, init_distributed, launched
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask

    device = init_distributed(args.device) if launched() else resolve_device(args.device)
    mesh = create_mesh()
    cfg = get_experiment_config("mmt/classification")
    for path in args.config_file:
        cfg = from_yaml_file(cfg, path, strict=True)
    if args.params_override:
        cfg = parse_params_override(cfg, args.params_override, strict=True)

    with open(args.input_meta_data_path) as f:
        meta = json.load(f)

    # Sharded scoring needs batch % ranks == 0: round up rather than fail.
    batch_size = args.predict_global_batch_size
    if batch_size % mesh.num_data:
        batch_size = -(-batch_size // mesh.num_data) * mesh.num_data
        logging.info("rounded predict batch %d -> %d (%d ranks)",
                     args.predict_global_batch_size, batch_size, mesh.num_data)
    data_cfg = build_retrieval_data_config(
        cfg.task.train_data, meta, args.predict_split, batch_size
    )
    # Retrieval scoring uses the classification model at the meta seq len.
    cfg = dataclasses.replace(cfg, task=dataclasses.replace(cfg.task, train_data=data_cfg))

    state = CheckpointManager(args.init_checkpoint).restore()
    task = ClassificationTask(cfg.task, cfg.trainer, device=device)
    task.model.load_state_dict(state)
    logging.info("restored checkpoint from %s", args.init_checkpoint)

    loader = MmtRetrievalLoader(data_cfg)
    if args.export_serving_artifact and not mesh.is_chief:
        return
    if args.export_serving_artifact:
        from mmt_tpu_torch.eval import export

        first = next(iter(loader.load()))
        params = task.model.state_dict()
        if args.export_bucket_sizes:
            blob = export.export_scoring_bundle(task, params, first,
                                                batch_sizes=args.export_bucket_sizes)
        else:
            impl = cfg.task.model.encoder.get().attention_impl
            blob = export.export_scoring(task, params, first,
                                         symbolic_batch=(impl != "pallas"))
        with open(args.export_serving_artifact, "wb") as f:
            f.write(blob)
        logging.info("wrote serving artifact (%d bytes) to %s",
                     len(blob), args.export_serving_artifact)
        return

    step = task.make_inference_step()
    if mesh.distributed:
        step = sharded_inference_step(step, mesh)
        logging.info("sharding predict over %d ranks", mesh.num_data)
    results = predict(step, loader.load())
    if not mesh.is_chief:
        for _ in results:  # every rank takes part in every batch's gather
            pass
        return
    recall = write_results(results, args.test_output_dir)
    print(json.dumps(recall, indent=2))


if __name__ == "__main__":
    main()
