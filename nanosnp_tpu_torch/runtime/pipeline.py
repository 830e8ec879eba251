"""Stage-graph pipeline runner.

Replaces the reference's run_caller.sh + per-stage shell scripts
(run_caller.sh:94-141) with a Python orchestrator: explicit stage graph,
`.done`-marker resumability (the reference's make_predict_data.sh pattern),
per-stage logs and wall/throughput metrics, one unified config.
"""
from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Stage:
    name: str
    fn: Callable[..., Optional[dict]]   # returns optional metrics dict
    description: str = ""
    # Config fingerprint stored in the .done marker. On resume, a marker
    # whose stored fingerprint differs from the stage's current one is
    # stale (the user changed a knob that feeds this stage, e.g.
    # --defer-unphased-frac into s5) and the stage reruns — without this,
    # rerunning `call` in the same output dir silently reuses the old
    # artifact and the flag has no effect.
    fingerprint: Optional[str] = None


@dataclass
class StageResult:
    name: str
    seconds: float
    skipped: bool
    metrics: Dict = field(default_factory=dict)


class PipelineRunner:
    def __init__(self, output_dir: str, logger: Optional[logging.Logger] = None):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.marker_dir = os.path.join(output_dir, ".stages")
        os.makedirs(self.marker_dir, exist_ok=True)
        self.log = logger or self._make_logger()
        self.results: List[StageResult] = []

    def _make_logger(self) -> logging.Logger:
        logger = logging.getLogger(f"nanosnp.{os.path.basename(self.output_dir)}")
        logger.setLevel(logging.INFO)
        if not logger.handlers:
            fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s")
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            logger.addHandler(sh)
            fh = logging.FileHandler(os.path.join(self.output_dir, "pipeline.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        return logger

    def _marker(self, name: str) -> str:
        return os.path.join(self.marker_dir, f"{name}.done")

    def run(self, stages: List[Stage], resume: bool = True, **ctx) -> List[StageResult]:
        # once any stage actually runs, every later marker is stale (its
        # input artifact just changed), so the skip window closes.
        invalidated = False
        for st in stages:
            marker = self._marker(st.name)
            skip = resume and not invalidated and os.path.exists(marker)
            if skip and st.fingerprint is not None:
                try:
                    with open(marker) as f:
                        stored = json.load(f).get("fingerprint")
                except (OSError, ValueError):
                    stored = None
                if stored != st.fingerprint:
                    self.log.info(
                        "stage %s: marker fingerprint %r != current %r "
                        "(config changed), rerunning",
                        st.name, stored, st.fingerprint)
                    skip = False
            if skip:
                self.log.info("stage %s: already done, skipping", st.name)
                self.results.append(StageResult(st.name, 0.0, True))
                continue
            invalidated = True
            self.log.info("stage %s: start (%s)", st.name, st.description)
            t0 = time.monotonic()
            from ..utils.profiling import maybe_profile, session

            # NSP_PROFILE_DIR gates the trace, and the trace the session
            with maybe_profile(st.name), session(f"nsp.pipeline.{st.name}"):
                metrics = st.fn(**ctx) or {}
            dt = time.monotonic() - t0
            with open(marker, "w") as f:
                json.dump({"seconds": dt, "metrics": metrics,
                           "fingerprint": st.fingerprint}, f)
            self.log.info("stage %s: done in %.1fs %s", st.name, dt,
                          json.dumps(metrics) if metrics else "")
            self.results.append(StageResult(st.name, dt, False, metrics))
        return self.results

    def reset(self, names: Optional[List[str]] = None) -> None:
        for f in os.listdir(self.marker_dir):
            name = f[: -len(".done")]
            if names is None or name in names:
                os.remove(os.path.join(self.marker_dir, f))
