"""The port's TensorBoard event files against the JAX package's.

* The encoders and ``TBEventWriter``: byte for byte the JAX package's for
  the same scalars, with ``time.time`` and the host name pinned in both
  (``wall_time`` is a double and ``simple_value`` a float32 in the file);
* TF's own ``summary_iterator`` reads the port's file (skipped where TF is
  missing);
* ``run_training`` with ``tensorboard_summaries``: one event file in
  ``summaries/train`` and one in ``summaries/validation``, whose scalars
  equal the jsonl summaries to float32; none without it.
"""

import glob
import json
import os
import socket
import struct
import time

import numpy as np
import pytest

from mmt_tpu.utils import tb_events as jax_tb
from mmt_tpu_torch.configs import TrainerConfig
from mmt_tpu_torch.data.tfrecord import TFRecordReader, _read_varint
from mmt_tpu_torch.train.loop import run_training
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.tasks import batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from mmt_tpu_torch.utils import tb_events
from tests.test_torch_train import _batch, _torch_task

SCALARS = [
    (1, {"loss": 3.25, "mlm_accuracy": 0.125}),
    (200000, {"loss": -1.5e-3, "steps_per_sec": 1234.5678}),
    (7, {}),
    (2**40, {"ünïcode/tag": float("inf"), "nan": float("nan"), "tiny": 1e-45}),
]


def read_events(path):
    """(step, wall_time, {tag: float32}) of every Event in an event file,
    decoded with the port's TFRecord reader; the file-version record as
    (None, wall_time, version)."""
    out = []
    for payload in TFRecordReader(path, check_crc=True):
        fields = _fields(payload)
        wall_time = struct.unpack("<d", fields[1])[0]
        if 3 in fields:
            out.append((None, wall_time, fields[3].decode()))
            continue
        tags = {}
        for value in _fields(fields[5], repeated=True).get(1, []):
            v = _fields(value)
            tags[v[1].decode()] = struct.unpack("<f", v[2])[0]
        out.append((fields[2], wall_time, tags))
    return out


def _fields(buf, repeated=False):
    """{field number: value} of a proto message (varints as ints, fixed
    and length-delimited fields as bytes); with ``repeated`` each value is
    a list."""
    out, pos = {}, 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        else:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        if repeated:
            out.setdefault(field, []).append(value)
        else:
            out[field] = value
    return out


def _write_pinned(monkeypatch, writer_cls, log_dir):
    """An event file of SCALARS written at a pinned clock (1.7e9 s, then
    0.25 s more at each read) and host name."""
    clock = iter(1.7e9 + 0.25 * i for i in range(1000))
    monkeypatch.setattr(time, "time", lambda: next(clock))
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    w = writer_cls(log_dir)
    for step, metrics in SCALARS:
        w.scalars(step, metrics)
    w.close()
    return w.path


@pytest.mark.parametrize("step,metrics", SCALARS)
def test_scalar_event_bytes_equal_jax(step, metrics):
    for wall_time in (0.0, 1712345678.123456789):
        assert tb_events.encode_scalar_event(step, metrics, wall_time) == \
            jax_tb.encode_scalar_event(step, metrics, wall_time)
    assert tb_events.encode_file_version_event(1.5) == jax_tb.encode_file_version_event(1.5)


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    port = _write_pinned(monkeypatch, tb_events.TBEventWriter, str(tmp_path / "torch"))
    jax = _write_pinned(monkeypatch, jax_tb.TBEventWriter, str(tmp_path / "jax"))
    assert os.path.basename(port) == os.path.basename(jax) == "events.out.tfevents.1700000000.host"
    with open(port, "rb") as f, open(jax, "rb") as g:
        got, want = f.read(), g.read()
    assert len(got) > 100 and got == want
    events = read_events(port)
    assert events[0][2] == "brain.Event:2"
    assert [e[0] for e in events[1:]] == [s for s, _ in SCALARS]
    assert events[1][2] == {"loss": 3.25, "mlm_accuracy": 0.125}


def test_tf_reads_port_events(tmp_path):
    tf = pytest.importorskip("tensorflow")
    w = tb_events.TBEventWriter(str(tmp_path / "train"))
    w.scalars(1, {"loss": 3.25, "mlm_accuracy": 0.125})
    w.scalars(200000, {"loss": -1.5e-3})
    w.close()
    events = list(tf.compat.v1.train.summary_iterator(w.path))
    assert events[0].file_version == "brain.Event:2"
    assert [e.step for e in events[1:]] == [1, 200000]
    assert {v.tag: v.simple_value for v in events[1].summary.value} == \
        {"loss": 3.25, "mlm_accuracy": 0.125}
    np.testing.assert_allclose(events[2].summary.value[0].simple_value, -1.5e-3, rtol=1e-6)
    assert all(e.wall_time > 1.7e9 for e in events)


@pytest.mark.parametrize("tensorboard", [True, False])
def test_loop_writes_tb_summaries(tmp_path, tensorboard):
    task = _torch_task(steps=2)
    trainer = TrainerConfig(train_steps=2, steps_per_loop=1, summary_interval=1,
                            checkpoint_interval=2, validation_interval=1,
                            tensorboard_summaries=tensorboard)
    batch = _batch()
    model_dir = tmp_path / "m"
    state = TrainState.create(task.model, create_optimizer(trainer.optimizer_config, 2,
                                                           task.model))
    run_training(train_step=task.make_train_step(), state=state,
                 train_iter=iter(lambda: batch, None), place_batch=lambda b: batch_to_device(b, "cpu"),
                 trainer=trainer, model_dir=str(model_dir),
                 eval_fn=lambda state: {"auc": 0.75, "cls_loss": 1 / 3})
    train_files = glob.glob(str(model_dir / "summaries" / "train" / "events.out.tfevents.*"))
    val_files = glob.glob(str(model_dir / "summaries" / "validation" / "events.out.tfevents.*"))
    if not tensorboard:
        assert not (model_dir / "summaries").exists()
        return
    assert len(train_files) == 1 and len(val_files) == 1
    for path, name in ((train_files[0], "train"), (val_files[0], "validation")):
        lines = [json.loads(l) for l in (model_dir / f"{name}_summaries.jsonl").read_text()
                 .splitlines()]
        events = read_events(path)[1:]
        assert [e[0] for e in events] == [l["step"] for l in lines] == [1, 2]
        for (_, _, tags), line in zip(events, lines):
            assert tags == {k: float(np.float32(v)) for k, v in line.items() if k != "step"}
    assert "steps_per_sec" in read_events(train_files[0])[1][2]


def test_chip_smoke_reads_the_loop_event_files(tmp_path):
    """chip_smoke's decoder and check of the finetune run's event files."""
    import chip_smoke
    from mmt_tpu_torch.train.loop import SummaryWriter

    writer = SummaryWriter(str(tmp_path), "validation", tensorboard=True)
    lines = [{"step": 2, "auc": 0.1, "cls_loss": 2.5}, {"step": 4, "auc": 1 / 3, "cls_loss": 0.0}]
    for line in lines:
        writer.write(line["step"], {k: v for k, v in line.items() if k != "step"})
    writer.close()
    chip_smoke.check_event_files(tmp_path, "validation", lines)
    path, = (tmp_path / "summaries" / "validation").iterdir()
    assert chip_smoke.read_event_scalars(path) == [(s, t) for s, _, t in read_events(str(path))[1:]]
    with pytest.raises(AssertionError, match="events"):
        chip_smoke.check_event_files(tmp_path, "validation", lines[:1])
