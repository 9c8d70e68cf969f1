#!/usr/bin/env python3
"""Holds the resume bound of ``chip_smoke.py``'s phase finetune against the
runs it must pass and the resumes it must refuse, on one CUDA card.

    python3 scripts/resume_bound_check.py [--whole_runs=4]

Builds the kernels, writes the phase's seeded Flickr30k records and WIT
pretraining checkpoint, and runs ``cli.train.main`` on the phase's finetune
experiment: one 4-step run, ``--whole_runs`` uninterrupted 6-step runs, and
copies of the 4-step run taken on to step 6, once as they are and once
broken each way: the input stream's snapshot deleted (the stream restarts
from epoch 0), another ``--seed`` (other dropout masks), the optimizer's
count one step back, and the Adam moments rounded to bfloat16.

Every step of every run records the itm head's bias and its first Adam
moment, from which the bias's gradient at each step follows
(``g = (mu - b1 mu_prev) / (1 - b1)``).  Each uninterrupted run is then
held against every pair of the others (a null control, which a
sound bound passes) and each resume against pairs of uninterrupted runs,
both by ``chip_smoke.resume_errors`` and by the bound without its
gradient-rounding term (``RESUME_GRAD_SPACING`` = 0); the input stream's
step-6 snapshot is compared too.  Prints one JSON line per comparison and
writes them, with the per-step records, to
``chiprun_out/resume_bound_check.json``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

BIAS = "cls_heads.itm.out_proj.bias"


def record_steps(records: list):
    """Wraps ``train.loop.run_training`` so that each step appends the head
    bias and its first moment (hex floats) to ``records[-1]``."""
    import mmt_tpu_torch.train.loop as loop

    run_training = loop.run_training

    def recording(**kw):
        train_step = kw["train_step"]

        def step(state, batch, rngs):
            out = train_step(state, batch, rngs)
            bias = dict(out[0].model.named_parameters())[BIAS]
            records[-1]["steps"].append({
                "bias": [float(x).hex() for x in bias.detach().cpu().tolist()],
                "mu": [float(x).hex() for x in out[0].optimizer.mu[BIAS].cpu().tolist()]})
            return out

        kw["train_step"] = step
        return run_training(**kw)

    loop.run_training = recording


def bias_gradients(steps: list, b1: float) -> list:
    """The head bias's first gradient element at each step, from its
    first moments."""
    mus = [float.fromhex(s["mu"][0]) for s in steps]
    return [(m - b1 * prev) / (1 - b1) for prev, m in zip([0.0] + mus, mus)]


def compare(tag: str, run: dict, pair: list, lr_sum: float, stream_equal: bool) -> dict:
    new = cs.resume_errors(run, pair, lr_sum)
    old = cs.resume_errors(run, pair, 0.0)  # without the gradient-rounding term
    norm = pair[0][BIAS].norm().item()
    row = {"tag": tag, "tensors_failing": new["tensors_failing"],
           "tensors_failing_without_grad_term": old["tensors_failing"],
           "first_failing": list(new["failing"]),
           "first_failing_without_grad_term": list(old["failing"]),
           "whole_model_rel_err": new["whole_model_rel_err"],
           "whole_model_rel_spread": new["whole_model_rel_spread"],
           "bias_rel_err": (run[BIAS] - pair[0][BIAS]).norm().item() / norm,
           "bias_rel_spread": (pair[1][BIAS] - pair[0][BIAS]).norm().item() / norm,
           "stream_equal": stream_equal}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--whole_runs", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("resume_bound_check: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()

    from mmt_tpu_torch.cli.train import build_experiment_config, parse_args
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.optimizer import create_learning_rate_fn
    from mmt_tpu_torch.train.tasks import PretrainingTask

    records, rows = [], []
    record_steps(records)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cs.write_flickr_records(root)
        cs.write_paired_flickr_records(root / "train.tfrecord", cs.FT_TRAIN_RECORDS, seed=1)
        cs.write_paired_flickr_records(root / "val.tfrecord", cs.FT_VAL_RECORDS, seed=2)
        pre_cfg = cs.pretrain_experiment()
        pretrain = PretrainingTask(pre_cfg.task, pre_cfg.trainer, device="cuda", seed=11)
        CheckpointManager(str(root / "pretrain")).save(0, pretrain.model)
        del pretrain
        torch.cuda.empty_cache()
        short = cs.finetune_experiment(root, str(root / "pretrain"), cs.FT_STEPS)
        config = cs.finetune_experiment(root, str(root / "pretrain"), cs.FT_RESUME_STEPS)
        cfg = build_experiment_config(parse_args([
            "--experiment=mmt/classification", "--model_dir=unused",
            f"--config_file={config}"]))
        learning_rate = create_learning_rate_fn(cfg.trainer.optimizer_config,
                                                cs.FT_RESUME_STEPS)
        lr_sum = sum(learning_rate(n) for n in range(cs.FT_RESUME_STEPS))
        b1 = cfg.trainer.optimizer_config.adamw.beta_1

        def run(name, config, model_dir, extra=()):
            records.append({"run": name, "steps": []})
            cs.run_train_cli(config, model_dir, extra=extra)

        run("short", short, root / "short")
        whole, streams = [], []
        for i in range(args.whole_runs):
            run(f"whole{i}", config, root / f"whole{i}")
            whole.append(cs.finetune_params(root / f"whole{i}", cs.FT_RESUME_STEPS))
            streams.append(cs.stream_snapshot(root / f"whole{i}", cs.FT_RESUME_STEPS))
            shutil.rmtree(root / f"whole{i}")
        for i in range(args.whole_runs):
            for j, k in itertools.combinations(sorted(set(range(args.whole_runs)) - {i}), 2):
                rows.append(compare(f"null: whole{i} against (whole{j}, whole{k})", whole[i],
                                    [whole[j], whole[k]], lr_sum, streams[i] == streams[j]))

        def edit_optimizer(model_dir, edit):
            path = model_dir / str(cs.FT_STEPS) / "optimizer.pt"
            state = torch.load(path, map_location="cpu", weights_only=True)
            edit(state)
            torch.save(state, f"{path}.new")
            os.replace(f"{path}.new", path)  # replaces the hard link, not its target

        def count_back(state):
            state["count"] -= 1

        def moments_bf16(state):
            for key in ("mu", "nu"):
                state[key] = {n: t.bfloat16().float() for n, t in state[key].items()}

        cases = (("resumed", None, ()), ("stream snapshot deleted", "stream", ()),
                 ("another --seed", None, ("--seed=1",)),
                 ("optimizer count one step back", count_back, ()),
                 ("Adam moments in bfloat16", moments_bf16, ()))
        for tag, edit, extra in cases:
            model_dir = root / "resumed"
            cs.link_copy(root / "short", model_dir)
            if edit == "stream":
                shutil.rmtree(model_dir / "data_stream")
            elif edit is not None:
                edit_optimizer(model_dir, edit)
            run(tag, config, model_dir, extra)
            params = cs.finetune_params(model_dir, cs.FT_RESUME_STEPS)
            stream = cs.stream_snapshot(model_dir, cs.FT_RESUME_STEPS)
            shutil.rmtree(model_dir)
            for j, k in itertools.combinations(range(min(args.whole_runs, 3)), 2):
                rows.append(compare(f"{tag} against (whole{j}, whole{k})", params,
                                    [whole[j], whole[k]], lr_sum, stream == streams[j]))
    for r in records:
        # A resumed run's moments continue those of the 4-step run's steps.
        resumed = not r["run"].startswith(("short", "whole"))
        r["bias_gradient"] = bias_gradients(
            (records[0]["steps"] if resumed else []) + r["steps"], b1)
        print(json.dumps({"run": r["run"], "bias_gradient": r["bias_gradient"],
                          "bias": r["steps"][-1]["bias"]}), flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "resume_bound_check.json").write_text(json.dumps(
        {"lr_sum": lr_sum, "comparisons": rows, "runs": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
