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
carry on on the CPU).  One device: the JAX CLI's multi-device batch
rounding and mesh have no counterpart yet, and the serving-artifact export
flags raise.  A yaml ``--config_file`` needs pyyaml; one written as JSON
text loads without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging


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
    p.add_argument("--export_serving_artifact", default="",
                   help="not ported yet (the serving export, Slice D): raises")
    p.add_argument("--export_bucket_sizes", default="",
                   help="not ported yet (the serving export, Slice D): raises")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


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
    if args.export_serving_artifact or args.export_bucket_sizes:
        raise NotImplementedError(
            "--export_serving_artifact / --export_bucket_sizes: the serving export "
            "(Slice D of the port) is not ported yet")

    from mmt_tpu_torch.configs import get_experiment_config
    from mmt_tpu_torch.configs.base import from_yaml_file, parse_params_override
    from mmt_tpu_torch.data.loaders import MmtRetrievalLoader
    from mmt_tpu_torch.device import resolve_device
    from mmt_tpu_torch.eval.predict import predict, write_results
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask

    device = resolve_device(args.device)
    cfg = get_experiment_config("mmt/classification")
    for path in args.config_file:
        cfg = from_yaml_file(cfg, path, strict=True)
    if args.params_override:
        cfg = parse_params_override(cfg, args.params_override, strict=True)

    with open(args.input_meta_data_path) as f:
        meta = json.load(f)

    data_cfg = build_retrieval_data_config(
        cfg.task.train_data, meta, args.predict_split, args.predict_global_batch_size
    )
    # Retrieval scoring uses the classification model at the meta seq len.
    cfg = dataclasses.replace(cfg, task=dataclasses.replace(cfg.task, train_data=data_cfg))

    state = CheckpointManager(args.init_checkpoint).restore()
    task = ClassificationTask(cfg.task, cfg.trainer, device=device)
    task.model.load_state_dict(state)
    logging.info("restored checkpoint from %s", args.init_checkpoint)

    loader = MmtRetrievalLoader(data_cfg)
    results = predict(task.make_inference_step(), loader.load())
    recall = write_results(results, args.test_output_dir)
    print(json.dumps(recall, indent=2))


if __name__ == "__main__":
    main()
