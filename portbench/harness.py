"""The benchmark's harness, driven by data: a cell (an entry of
``BENCHMARK.json``'s ``workloads``) names a configuration and a traffic
mix; the harness finds ``configs/<config>.json``, ``traffic/<traffic>.json``
(which names its driver, ``drivers/<driver>.py``), ``limits/<cell>.json``
and a reader ``metrics/<metric>.py`` for each per-layer metric, by those
names alone.

A run: the driver sets the cell up (``setup_s`` counts from the start of
the process to the window's opening), measures for the window's seconds,
and with ``--trace 1`` traces a few units of work after the window; the
device's peak memory is read, the program's state freed, and the
reference judges what the timed path produced. The result's last line is
one JSON object; the numbers compared, each beside its limit, close both
standard error and that line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aloception_tpu")
#: The control's precision: the nearest below the one a cell states.
BELOW = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}
T0 = time.perf_counter()


def load_file(path: Path, name: str):
    """A Python file of the benchmark as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything a run of one cell needs, found by name."""

    def __init__(self, bench: Dict, workload: str, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        self.base = base
        self.config = read_json(base / "configs"
                                / f"{self.entry['config']}.json")
        self.traffic = read_json(base / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.precision = stated_precision(self.traffic)
        self.limits, self.control = cell_limits(
            base / "limits" / f"{workload}.json", self.precision)
        self.driver = load_file(base / "drivers"
                                / f"{self.traffic['driver']}.py",
                                f"portbench_driver_{self.traffic['driver']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])
                          and m["moves"] in reported]

    def reader(self, metric: str):
        return load_file(self.base / "metrics" / f"{metric}.py",
                         f"portbench_metric_{metric.replace('.', '_')}")


def stated_precision(traffic: Dict) -> str:
    """The precision a cell runs in, as its traffic mix states it
    (``dtype``; float32 with ``tf32`` on reads ``tf32``)."""
    if traffic["dtype"] == "float32" and traffic.get("tf32", False):
        return "tf32"
    return traffic["dtype"]


def cell_limits(path: Path, precision: str):
    """The limits of a cell's compared numbers and its control's
    precision. A cell without limits, with none in the file, or whose
    file was set for another precision than the cell states, is refused:
    nothing would be compared, or the control would not be the precision
    below the cell's."""
    if not path.exists():
        raise FileNotFoundError(f"{path}: a cell needs its limits file")
    spec = read_json(path)
    if not spec.get("numbers"):
        raise ValueError(f"{path}: no numbers to compare")
    if spec.get("precision") != precision:
        raise ValueError(f"{path}: limits set for precision "
                         f"{spec.get('precision')!r}, the cell runs "
                         f"{precision!r}")
    if precision not in BELOW:
        raise ValueError(f"no control below precision {precision!r}")
    return spec["numbers"], BELOW[precision]


def setup_mark(phase: str):
    """A set-up phase's end on standard error, in seconds from the
    process's start."""
    print(f"set-up {phase}: {time.perf_counter() - T0:.2f} s",
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Modules of the JAX stack or the JAX package loaded in this process,
    compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def finite(x: float) -> float:
    """A number JSON can carry: infinities as +-1e300, NaN as 1e300."""
    if isinstance(x, float) and not math.isfinite(x):
        return -1e300 if x < 0 else 1e300
    return x


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi`` (None where it cannot
    say)."""
    import subprocess
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(res.stdout.split()[0])
    except Exception:
        return None


def make_driver(cell: Cell, seed: int, device: str,
                overrides: Optional[Dict] = None):
    """The cell's driver on ``device``. ``overrides`` replace configuration
    and traffic keys (the CPU tests' tiny sizes)."""
    import torch
    if overrides:
        cell.config = dict(cell.config, **overrides.get("config", {}))
        cell.traffic = dict(cell.traffic, **overrides.get("traffic", {}))
    return cell.driver.Driver(cell, seed, torch.device(device))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float, overrides: Optional[Dict] = None
             ) -> Dict:
    """One run of ``cell``: its result line as a dict, with the numbers
    compared under ``checks``."""
    import torch
    from portbench import program
    global T0
    T0 = t0
    setup_mark("imports")
    driver = make_driver(cell, seed, device, overrides)
    driver.setup()
    run = driver.measure(seconds, trace)
    setup_s = run["window_start"] - t0
    window_note(run["unit_s"], device)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") \
        else 0
    driver.release()
    numbers = driver.numbers("program")
    from portbench.reference.compare import judged
    verdict = judged(numbers, cell.limits)

    metrics = {}
    if not trace:
        values = dict(run["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        readings = run["readings"]
        readings["flops_per_image"] = driver.flops_per_image()
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict["correct"],
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics,
              "device": program.device_info(
                  driver.device, peak,
                  power_limit_w() if device.startswith("cuda") else None)}
    if trace:
        busy = run["readings"]["device_busy"]
        if busy is not None:
            result["device"]["busy_s"] = busy[1] / 1e6
            result["device"]["window_s"] = busy[2] / 1e6
        if run["readings"].get("breakdown"):
            result["breakdown"] = run["readings"]["breakdown"]
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in verdict["checks"].items()}
    return result


def window_note(unit_s: List[float], device: str):
    """A look at the window on standard error: each unit's host time by
    quantiles, the slowest units' places, and the card's clock, power and
    temperature as it closed."""
    import statistics
    ms = [u * 1e3 for u in unit_s]
    q = statistics.quantiles(ms, n=10) if len(ms) > 1 else ms * 9
    slow = sorted(range(len(ms)), key=lambda i: -ms[i])[:5]
    print(f"window: {len(ms)} units; ms p10 {q[0]:.2f} p50 {q[4]:.2f} "
          f"p90 {q[8]:.2f} max {max(ms):.2f}; slowest at "
          f"{[(i, round(ms[i], 1)) for i in slow]}", file=sys.stderr)
    if device.startswith("cuda"):
        import subprocess
        try:
            res = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                 "temperature.gpu", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
            print(f"card as the window closed: {res.stdout.strip()}",
                  file=sys.stderr)
        except Exception:
            pass


def report(result: Dict):
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()


def cache_dirs(root: Path):
    """Every build and kernel cache of the program at fixed paths inside
    the checkout (the MSDA and Hungarian libraries already build into
    ``aloception_tpu_torch/_build``)."""
    base = root / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def now() -> float:
    return time.perf_counter()
