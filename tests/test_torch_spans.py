"""The port's named spans (``utils/profiling.py::span``) on the CPU: a
shared no-op with no profiler, and under ``torch.profiler`` the
``alo.*`` ranges of the Trainer's step, the Frame path and the models,
nested as a trace reader walks them."""

import ast
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from aloception_tpu_torch.aloscene import Frame, batch_list
from aloception_tpu_torch.models.deformable_detr import \
    inference as deformable_inference
from aloception_tpu_torch.models.detr import inference as detr_inference
from aloception_tpu_torch.utils import profiling

from test_torch_trainer import (make_trainer, private_config,  # noqa: F401
                                tiny_detr)

PACKAGE = Path(profiling.__file__).resolve().parents[1]
#: Every span of the program, by name.
SPANS = {
    "alo.trainer.step", "alo.trainer.prepare_batch", "alo.trainer.to_device",
    "alo.trainer.forward", "alo.trainer.criterion", "alo.trainer.backward",
    "alo.trainer.optimizer", "alo.trainer.fetch", "alo.trainer.callbacks",
    "alo.frame.init", "alo.frame.norm_resnet", "alo.aug.resize",
    "alo.spatial.batch_list", "alo.model.backbone", "alo.model.transformer",
    "alo.model.inference", "alo.raft.encoders", "alo.raft.corr",
    "alo.raft.lookup", "alo.raft.update", "alo.raft.upsample"}
#: The labels that the port's benchmark puts around the program from
#: outside (wrappers and forward hooks): a span never takes one of them.
BENCHMARK_LABELS = {"frame path", "model", "backbone", "transformer",
                    "inference", "to host", "prepare_batch", "to_device",
                    "train_step"}
STEP_PARTS = ["alo.trainer.prepare_batch", "alo.trainer.to_device",
              "alo.trainer.forward", "alo.trainer.criterion",
              "alo.trainer.backward", "alo.trainer.optimizer",
              "alo.trainer.fetch", "alo.trainer.callbacks"]


def spans_of(prof):
    return [e for e in prof.events() if e.name.startswith("alo.")]


def enclosing_span(event):
    """The innermost ``alo.*`` span among the event's callers."""
    a = event.cpu_parent
    while a is not None and not a.name.startswith("alo."):
        a = a.cpu_parent
    return a


def test_span_off_is_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("a span built a record_function with no "
                             "profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("alo.a"), profiling.span("alo.b")
    assert a is b
    with a as got:
        assert got is None


def test_span_on_records_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(profiling.span("alo.x"),
                          torch.profiler.record_function)
        with profiling.span("alo.x"):
            torch.ones(2).add_(1)
    (x,) = spans_of(prof)
    assert x.name == "alo.x"
    assert any(enclosing_span(e) is x for e in prof.events()
               if e.name == "aten::add_")


def test_span_is_left_out_of_an_exported_graph():
    class Twice(torch.nn.Module):
        def forward(self, x):
            with profiling.span("alo.test"):
                return x * 2

    with profile(activities=[ProfilerActivity.CPU]):
        ep = torch.export.export(Twice(), (torch.ones(3),), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets == ["aten.mul.Tensor"]


def test_trainer_step_spans(tmp_path):
    trainer = make_trainer(tmp_path, limit_train_batches=2)
    loader = trainer.data_module.train_dataloader()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit(loader, max_epochs=1)
    assert trainer.global_step == 2
    spans = spans_of(prof)
    steps = sorted((e for e in spans if e.name == "alo.trainer.step"),
                   key=lambda e: e.time_range.start)
    assert len(steps) == 2
    for step in steps:
        parts = sorted((e for e in spans if enclosing_span(e) is step),
                       key=lambda e: e.time_range.start)
        assert [e.name for e in parts] == STEP_PARTS
    forward = [e for e in spans if e.name == "alo.trainer.forward"]
    assert {enclosing_span(e).name for e in spans
            if e.name.startswith("alo.model.")} == {"alo.trainer.forward"}
    assert len(forward) == 2


def test_frame_path_spans():
    frames = [torch.rand(3, h, w) * 255 for h, w in
              ((24, 32), (30, 20), (16, 16))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fs = [Frame(x).norm_resnet().resize((16, 24)) for x in frames]
        batch = batch_list(fs, size=(32, 32))
    assert batch.array.shape[0] == 3
    names = [e.name for e in spans_of(prof)]
    assert {n: names.count(n) for n in set(names)} == {
        "alo.frame.init": 3, "alo.frame.norm_resnet": 3, "alo.aug.resize": 3,
        "alo.spatial.batch_list": 1}


def test_model_spans():
    model = tiny_detr(4).eval()
    images, mask = torch.randn(2, 64, 64, 3), torch.zeros(2, 64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            out = model(images, mask)
        detr_inference(out)
        deformable_inference(out)
    spans = spans_of(prof)
    names = [e.name for e in spans]
    assert names.count("alo.model.backbone") == 1
    assert names.count("alo.model.transformer") == 1
    assert names.count("alo.model.inference") == 2
    assert all(enclosing_span(e) is None for e in spans)


def span_names_in_the_package():
    """The names of every ``span(...)`` call in the port's sources."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"):
                (arg,) = node.args
                names.add(arg.value)
    return names


def test_span_names():
    names = span_names_in_the_package()
    assert names == SPANS
    assert all(n.startswith("alo.") for n in names)
    assert not names & BENCHMARK_LABELS
