"""Experiment management (counterpart of
``aloception_tpu/train/experiment.py``).

Log and checkpoint directories resolve through
``~/.aloception_tpu/alonet_config.json`` (``CONFIG_PATH``); experiment
names get a date suffix; run ids allow resume.
"""

from __future__ import annotations

import datetime
import json
import os
import uuid
from typing import Optional, Tuple

CONFIG_PATH = os.path.expanduser("~/.aloception_tpu/alonet_config.json")


def load_alonet_config() -> dict:
    if os.path.exists(CONFIG_PATH):
        with open(CONFIG_PATH) as f:
            return json.load(f)
    return {}


def save_alonet_config(cfg: dict):
    os.makedirs(os.path.dirname(CONFIG_PATH), exist_ok=True)
    with open(CONFIG_PATH, "w") as f:
        json.dump(cfg, f, indent=2)


def resolve_log_dir(log_dir: Optional[str] = None) -> str:
    cfg = load_alonet_config()
    if log_dir is not None:
        log_dir = os.path.expanduser(log_dir)
        if cfg.get("log_dir") != log_dir:
            cfg["log_dir"] = log_dir
            save_alonet_config(cfg)
        return log_dir
    if "log_dir" in cfg:
        return cfg["log_dir"]
    default = os.path.expanduser("~/.aloception_tpu/experiments")
    cfg["log_dir"] = default
    save_alonet_config(cfg)
    return default


def get_expe_infos(project: str, expe_name: str, log_dir: Optional[str] = None,
                   run_id: Optional[str] = None, no_suffix: bool = False
                   ) -> Tuple[str, str, str]:
    """Returns (expe_name with a date suffix, run_id, checkpoint dir)."""
    base = resolve_log_dir(log_dir)
    if not no_suffix and run_id is None:
        expe_name = f"{expe_name}_{datetime.datetime.now():%Y-%m-%d_%H-%M-%S}"
    run_id = run_id or uuid.uuid4().hex[:8]
    ckpt_dir = os.path.join(base, project, expe_name, run_id)
    os.makedirs(ckpt_dir, exist_ok=True)
    return expe_name, run_id, ckpt_dir


def find_run_dir(run_id: str, project: Optional[str] = None,
                 log_dir: Optional[str] = None) -> str:
    """The checkpoint dir of a run from its run_id: scans
    ``<log_dir>/<project>/<expe_name>/<run_id>``; ``project=None`` scans
    every project."""
    base = resolve_log_dir(log_dir)
    projects = [project] if project else sorted(os.listdir(base)) \
        if os.path.isdir(base) else []
    for proj in projects:
        pdir = os.path.join(base, proj)
        if not os.path.isdir(pdir):
            continue
        for expe in sorted(os.listdir(pdir)):
            cand = os.path.join(pdir, expe, run_id)
            if os.path.isdir(cand):
                return cand
    raise FileNotFoundError(
        f"run_id {run_id!r} not found under {base}"
        + (f" (project {project!r})" if project else ""))
