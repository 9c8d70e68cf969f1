"""Preemption through the port's train CLI, in subprocesses on the CPU.

``python -m mmt_tpu_torch.cli.train`` (through a ``-c`` runner that turns
on deterministic algorithms) finetunes the tiny classification model of
``tests/test_torch_finetune.py`` from records, with hidden and attention
dropout 0.1, and gets SIGTERM once ``train_summaries.jsonl`` shows step 3
(each train summary is slowed by 0.3 s in that run so that the signal
lands mid-run).  It must exit 0 after logging the preemption at a step k
before the last, with ``k/model.pt`` and the stream's snapshot written.
The same command run again logs "resumed from checkpoint at step k" and
finishes, and its final parameters and optimizer state equal an
uninterrupted run's bit for bit.  The first run is driven by
``chip_smoke.preempt_cli``, as the card's finetune phase drives its own.

With ``num_workers: 2`` the SIGTERM goes to the whole process group, as
many schedulers send it, so the loader processes get it too.  A
``--gin_params`` binding, which the loader processes replay, slows their
loader by 0.5 s a batch, so that the training process waits on them when
the signal comes.  The workers ignore it, the run exits 0 with its
checkpoint, the rerun resumes (its stream restarts, as with loader
processes it always does) and no process of the group is left behind.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch
import yaml

from tests.test_torch_finetune import cli_yaml, write_paired_records, write_vocab

REPO = Path(__file__).resolve().parent.parent
STEPS = 8
RUNNER = """
import sys, time
import torch
torch.use_deterministic_algorithms(True)
if sys.argv[1] == "slow":
    from mmt_tpu_torch.train import loop
    write = loop.SummaryWriter.write
    def slow_write(self, step, metrics):
        write(self, step, metrics)
        if self.path.endswith("train_summaries.jsonl"):
            time.sleep(0.3)
    loop.SummaryWriter.write = slow_write
from mmt_tpu_torch.cli.train import main
main(sys.argv[2:])
"""


def _config(tmp_path, steps=STEPS, validation_interval=2, **data):
    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 40, seed=0)
    val = write_paired_records(tmp_path / "val.tfrecord", 8, seed=1)
    experiment = cli_yaml(vocab, train, val, "pallas", steps=steps, hidden_dropout=0.1,
                          attention_dropout=0.1)
    experiment["task"]["train_data"].update(data)
    experiment["trainer"]["validation_interval"] = validation_interval
    path = tmp_path / "itm.yaml"
    path.write_text(yaml.safe_dump(experiment))
    return path


SLOW_LOADER = ("--gin_params=mmt_tpu_torch.data.loaders.MmtClassificationLoader.load = "
               "@tests.test_torch_bindings_fixture.slow_classification_load")


def _command(mode, config, model_dir, *extra):
    return [sys.executable, "-c", RUNNER, mode, "--experiment=mmt/classification",
            "--mode=train_and_eval", f"--model_dir={model_dir}", f"--config_file={config}",
            "--device=cpu", *extra]


def _run(mode, config, model_dir):
    out = subprocess.run(_command(mode, config, model_dir), cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stderr


def _preempt(config, model_dir, whole_group=False, at_step=3):
    """Runs the command until train_summaries.jsonl shows ``at_step``, sends
    SIGTERM (to the process group with ``whole_group``, whose loader is
    slowed instead of its summaries); returns (exit code, log, process
    group id)."""
    command = (_command("fast", config, model_dir, SLOW_LOADER) if whole_group
               else _command("slow", config, model_dir))
    proc = subprocess.Popen(command, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    summaries = model_dir / "train_summaries.jsonl"
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and proc.poll() is None:
        if summaries.exists() and f'"step": {at_step},' in summaries.read_text():
            break
        time.sleep(0.02)
    if whole_group:
        os.killpg(proc.pid, signal.SIGTERM)
    else:
        proc.send_signal(signal.SIGTERM)
    log, _ = proc.communicate(timeout=120)
    return proc.returncode, log, proc.pid


def _preempted_step(log):
    lines = [l for l in log.splitlines() if "exiting after preemption checkpoint at step" in l]
    assert len(lines) == 1, log[-3000:]
    return int(lines[0].rsplit(" ", 1)[1])


def _group_gone(pgid, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


def test_sigterm_exits_0_and_the_rerun_resumes_bit_equal(tmp_path):
    """Driven by chip_smoke.preempt_cli, which the card's finetune phase
    runs on the full-width CLI."""
    import chip_smoke

    config = _config(tmp_path)
    cut = tmp_path / "cut"
    result = chip_smoke.preempt_cli(_command("slow", config, cut), cut, tmp_path / "cut.log",
                                    at_step=3)
    k = result["step"]
    assert result["exit_code"] == 0 and 0 < result["signal_to_exit_seconds"] < 60
    assert 3 <= k < STEPS
    assert (cut / str(k) / "model.pt").exists() and (cut / str(k) / "optimizer.pt").exists()
    assert (cut / "data_stream" / f"step_{k}.pkl").exists()
    assert (cut / "summaries" / "train").is_dir()

    log = _run("fast", config, cut)
    assert f"resumed from checkpoint at step {k}" in log
    assert "input stream resumed" in log
    _run("fast", config, tmp_path / "whole")
    got = torch.load(cut / str(STEPS) / "model.pt", weights_only=True)
    want = torch.load(tmp_path / "whole" / str(STEPS) / "model.pt", weights_only=True)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    opt_got, opt_want = (torch.load(d / str(STEPS) / "optimizer.pt", weights_only=True)
                         for d in (cut, tmp_path / "whole"))
    assert opt_got["count"] == opt_want["count"] == STEPS
    for key in ("mu", "nu"):
        for name in opt_want[key]:
            assert torch.equal(opt_got[key][name], opt_want[key][name]), (key, name)
    assert (chip_smoke.stream_snapshot(cut, STEPS)
            == chip_smoke.stream_snapshot(tmp_path / "whole", STEPS))


def test_chip_smoke_resume_bound():
    """The card's resume bound per tensor: 4 x the spread of two
    uninterrupted runs + 2 fp32 spacings + 2^-7 x the summed learning rates
    per element.  A bias grown from zero by six updates (~2e-7) passes one
    bfloat16 spacing of one step's gradient (1.6e-4 of its norm, which the
    card's uninterrupted runs show; above the fp32 floor alone) and fails
    a resume's other batches or count (1e-1); a large tensor fails 1e-6."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    lr_sum = 2e-7
    whole = {"bias": torch.tensor([1.98e-7, -1.98e-7]),
             "weight": 0.02 * torch.randn(256, 256, generator=gen)}
    pair = [whole, dict(whole)]

    def moved(name, rel):
        return {**whole, name: whole[name] * (1 + rel)}

    flip = moved("bias", 1.6e-4)
    assert not chip_smoke.resume_errors(flip, pair, lr_sum)["failing"]
    assert list(chip_smoke.resume_errors(flip, pair, 0.0)["failing"]) == ["bias"]
    assert list(chip_smoke.resume_errors(moved("bias", 1e-1), pair, lr_sum)["failing"]) == ["bias"]
    assert list(chip_smoke.resume_errors(moved("weight", 1e-6), pair, lr_sum)["failing"]) \
        == ["weight"]
    assert not chip_smoke.resume_errors(moved("weight", 1e-7), pair, lr_sum)["failing"]
    # A run-to-run spread widens the bound by 4x itself.
    spread = [whole, moved("weight", 1e-6)]
    assert not chip_smoke.resume_errors(moved("weight", 3e-6), spread, lr_sum)["failing"]
    assert chip_smoke.resume_errors(moved("weight", 6e-6), spread, lr_sum)["tensors_failing"] == 1


def test_sigterm_to_the_process_group_with_loader_processes(tmp_path):
    # 8 batches are queued before the first step (4 a worker): the signal
    # comes at step 12, when the training process waits on its workers.
    steps = 24
    config = _config(tmp_path, steps=steps, validation_interval=steps, num_workers=2)
    model_dir = tmp_path / "m"
    code, log, pgid = _preempt(config, model_dir, whole_group=True, at_step=12)
    assert code == 0, log[-3000:]
    assert "Traceback" not in log, log[-3000:]
    k = _preempted_step(log)
    assert 12 <= k < steps and (model_dir / str(k) / "model.pt").exists()
    assert _group_gone(pgid)
    log = _run("fast", config, model_dir)
    assert f"resumed from checkpoint at step {k}" in log
    assert (model_dir / str(steps) / "model.pt").exists()
