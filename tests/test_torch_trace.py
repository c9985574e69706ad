"""The port's spans (``maxsquareloss_torch/utils/debug.py``) on the CPU, at
a small model (``blocks=(2, 2, 2, 2)``: one identity block a layer, each on
``FusedBottleneckFn`` in training).

- With no profiler active a span is one shared null context, and a UDA
  step, an eval step and a predict call leave no record.
- Under a CPU ``torch.profiler``: one UDA step's Chrome trace holds one
  ``msl.step`` with two ``msl.forward``, one ``msl.loss``, one
  ``msl.backward`` and two ``msl.optimizer`` inside it, and one
  ``msl.block_backward`` per identity block and forward; its records share
  the step's unit and name their parents; its ``msl.sync`` spans are the
  two input batches' constants, the upsamples' interpolation matrices and
  the IW histogram. Eval and predict give one ``msl.forward`` a scale and
  one ``msl.tail`` a row chunk, and a ``msl.sync`` for each copy and
  confusion matrix in them.
- Each name's ring keeps ``RING`` records however many spans ran.
- ``torch.export`` with tracing off puts no profiler op in the graph.
"""

from __future__ import annotations

import collections
import json

import pytest
import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
from maxsquareloss_torch.predict import make_predict_fn, predict_core
from maxsquareloss_torch.train import steps
from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step
from maxsquareloss_torch.utils import debug

BLOCKS = (2, 2, 2, 2)
SRC_HW, TGT_HW = (33, 65), (25, 49)
EVAL_HW, LABEL_HW = (24, 48), (40, 64)
SCALES = (0.75, 1.0)
H_CHUNK = 16  # three row chunks of the 40 label rows
STEP_SPANS = ("msl.forward", "msl.loss", "msl.backward", "msl.optimizer")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    cfg = TrainConfig(blocks=BLOCKS)
    m = init_deeplabv2(steps.model_config(cfg), torch.Generator().manual_seed(3), device="cpu")
    return m.to(memory_format=torch.channels_last)


def _cfg(**kw):
    return TrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, device="cpu",
                       eval_h_chunk=H_CHUNK, **kw)


def _batch(seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (2, *SRC_HW, 3), generator=g, dtype=torch.uint8),
            torch.randint(-1, 19, (2, *SRC_HW), generator=g, dtype=torch.int32),
            torch.randint(0, 256, (2, *TGT_HW, 3), generator=g, dtype=torch.uint8))


def _eval_batch(seed=6):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (2, *EVAL_HW, 3), generator=g, dtype=torch.uint8),
            torch.randint(-1, 19, (2, *LABEL_HW), generator=g, dtype=torch.int32))


def _uda_step(model):
    cfg = _cfg()
    state = steps.make_train_state(model, cfg)
    step = steps.make_uda_train_step(cfg)
    return lambda: step(state, *_batch())


def _eval_step(model):
    step = make_multiscale_eval_step(_cfg(), model, SCALES, False)
    return lambda: step(*_eval_batch())


def _predict(model):
    fn = make_predict_fn(_cfg(), model, SCALES, False, LABEL_HW)
    return lambda: fn(_eval_batch()[0])


def _traced(run, tmp_path) -> list[dict]:
    """``run()`` under a CPU profiler: the Chrome trace's ``msl.*`` spans."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("msl.")]


def _names(spans) -> list[str]:
    return [e["name"] for e in spans]


def _inside(inner: dict, outer: dict) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _fused_blocks(model) -> int:
    return sum(b.fusable for layer in (model.layer1, model.layer2, model.layer3, model.layer4)
               for b in layer)


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert debug.span("msl.step") is debug.span("msl.forward") is debug.sync("histogram")
    with debug.span("msl.step") as entered:
        assert entered is None


@pytest.mark.parametrize("make", [_uda_step, _eval_step, _predict], ids=["uda", "eval", "predict"])
def test_no_record_with_tracing_off(model, make):
    run = make(model)
    before = debug.record_counts()
    run()
    assert debug.record_counts() == before


def test_uda_step_spans(model, tmp_path):
    run = _uda_step(model)
    before = debug.record_counts()
    spans = _traced(run, tmp_path)
    names = _names(spans)
    blocks = 2 * _fused_blocks(model)  # two forwards
    assert blocks == 8
    assert {n: names.count(n) for n in set(names)} == {
        "msl.step": 1, "msl.forward": 2, "msl.loss": 1, "msl.backward": 1, "msl.optimizer": 2,
        "msl.block_backward": blocks, "msl.sync": 11}
    step = next(e for e in spans if e["name"] == "msl.step")
    assert all(_inside(e, step) for e in spans)
    backward = next(e for e in spans if e["name"] == "msl.backward")
    assert all(_inside(e, backward) for e in spans if e["name"] == "msl.block_backward")
    made = {n: c - before.get(n, 0) for n, c in debug.record_counts().items()}
    assert {n: c for n, c in made.items() if c} == {n: names.count(n) for n in set(names)}
    recs = {n: debug.records(n, made[n]) for n in set(names)}
    (step_rec,) = recs["msl.step"]
    assert step_rec["parent"] is None and step_rec["host_ms"] > 0
    assert step_rec["device_ms"] is None  # no CUDA events on the CPU
    assert all(r["unit"] == step_rec["unit"] for rs in recs.values() for r in rs)
    for n in STEP_SPANS:
        assert all(r["parent"] == "msl.step" for r in recs[n])
    assert all(r["parent"] == "msl.backward" for r in recs["msl.block_backward"])
    # two forwards x two heads x two interpolation matrices
    assert collections.Counter((r["site"], r["parent"]) for r in recs["msl.sync"]) == {
        ("inputs", "msl.step"): 2, ("interp_matrix", "msl.forward"): 8,
        ("histogram", "msl.loss"): 1}
    # the next step is the next unit
    _traced(run, tmp_path)
    assert debug.records("msl.step", 1)[0]["unit"] == step_rec["unit"] + 1


@pytest.mark.parametrize("make,matrices", [(_eval_step, True), (_predict, False)],
                         ids=["eval", "predict"])
def test_eval_and_predict_spans(model, tmp_path, make, matrices):
    run = make(model)
    spans = _traced(run, tmp_path)
    names = _names(spans)
    chunks = -(-LABEL_HW[0] // H_CHUNK)
    assert names.count("msl.step") == 1
    assert names.count("msl.forward") == len(SCALES)
    assert names.count("msl.tail") == chunks == 3
    step = next(e for e in spans if e["name"] == "msl.step")
    assert all(_inside(e, step) for e in spans)
    tails = debug.records("msl.tail", chunks)
    assert all(r["parent"] == "msl.step" for r in tails)
    # the 0.75 view's input resize; each chunk upsamples both views' logits
    want = {("inputs", "msl.step"): 1, ("interp_matrix", "msl.forward"): 2,
            ("interp_matrix", "msl.tail"): 2 * len(SCALES) * chunks}
    if matrices:
        want[("confusion_matrix", "msl.tail")] = chunks
    syncs = debug.records("msl.sync", names.count("msl.sync"))
    assert collections.Counter((r["site"], r["parent"]) for r in syncs) == want


def test_ring_stays_bounded():
    before = debug.record_counts().get("msl.step", 0)
    n = debug.RING + 100
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(n):
            with debug.span("msl.step"):
                with debug.sync("test"):
                    pass
    assert debug.record_counts()["msl.step"] - before == n
    assert len(debug.records("msl.step", 2 * n)) == debug.RING
    last = debug.records("msl.sync", debug.RING)
    assert len(last) == debug.RING and last[-1]["site"] == "test"
    units = [r["unit"] for r in debug.records("msl.step", debug.RING)]
    assert units == list(range(units[0], units[0] + debug.RING))


def test_export_with_tracing_off_holds_no_profiler_op(model):
    """The serving graph as ``tools/export_inference.py`` traces it: its
    spans are null contexts, so no ``record_function`` op enters it."""
    fn = predict_core(_cfg(), model.eval(), SCALES, False, LABEL_HW)

    class Serve(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x):
            return fn(x)

    x = _eval_batch()[0]
    with torch.no_grad():
        ep = torch.export.export(Serve(), (x,))
        want = fn(x)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    with torch.no_grad():
        assert torch.equal(ep.module()(x), want)
