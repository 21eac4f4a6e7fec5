"""Training observability: the metric series and their grep-able lines.

Counterpart of the subset of the JAX package's `utils/metrics.py` that the
fedavg path records: per-client per-batch training loss, the per-round
dual residual, per-client test accuracy and phase wall times. Every
observation lands in an in-memory store (JSON-serializable) and, when
verbose, is printed in the same line format as the JAX package, so the
same shell recipes read both:

    layer=<gid> <nloop> minibatch=<s> epoch=<e> losses <l1>,<l2>,...
    layer=<gid>(<group size>) ADMM=<round> dual=<residual>
    Accuracy of client <k> on the test images: <pct> %
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class MetricsRecorder:
    """Append-only metric series, keyed by name; each record is a dict of
    the loop cursor (nloop/group/nadmm/...) plus `value`."""

    series: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    verbose: bool = True
    # cursor of the first non-finite loss/residual, or None while healthy
    first_nonfinite: Optional[dict] = None
    _t0: float = dataclasses.field(default_factory=time.perf_counter)

    def log(self, name: str, value: Any, **context) -> None:
        rec = {"t": time.perf_counter() - self._t0, "value": value, **context}
        self.series.setdefault(name, []).append(rec)

    @contextlib.contextmanager
    def phase(self, phase: str, sync=None, **context):
        """Record the wall seconds of the block as a `step_time` record.

        `sync`, when given, is called before the clock stops (e.g.
        `torch.cuda.synchronize`), so queued device work is counted.
        """
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.step_time(phase, time.perf_counter() - t0, **context)

    def _flag_nonfinite(self, name: str, values, context: dict) -> None:
        if self.first_nonfinite is not None:
            return
        if any(not math.isfinite(v) for v in values):
            self.first_nonfinite = {"series": name, **context}
            self.log("nonfinite_flag", {"series": name, **context})
            if self.verbose:
                ctx = " ".join(f"{k}={v}" for k, v in context.items())
                print(f"NONFINITE first non-finite {name} at {ctx}")

    def batch_losses(self, losses, *, nloop, group, nadmm, epoch, minibatch) -> None:
        """Per-client training losses for one lockstep minibatch."""
        vals = [float(v) for v in losses]
        ctx = dict(nloop=nloop, group=group, nadmm=nadmm, epoch=epoch, minibatch=minibatch)
        self._flag_nonfinite("train_loss", vals, ctx)
        self.log("train_loss", vals, **ctx)
        if self.verbose:
            print(
                f"layer={group} {nloop} minibatch={minibatch} epoch={epoch} "
                "losses " + ",".join(f"{v:e}" for v in vals)
            )

    def residuals(self, dual, *, nloop, group, nadmm, group_size) -> None:
        """The dual residual of one averaging round (FedAvg has no primal)."""
        ctx = dict(nloop=nloop, group=group, nadmm=nadmm)
        self._flag_nonfinite("residuals", [float(dual)], ctx)
        self.log("dual_residual", float(dual), **ctx)
        if self.verbose:
            print(f"layer={group}({group_size}) ADMM={nadmm} dual={float(dual):e}")

    def accuracies(self, accs, *, nloop, group, nadmm) -> None:
        """Per-client top-1 test accuracy (fractions in [0, 1])."""
        vals = [float(a) for a in accs]
        self.log("test_accuracy", vals, nloop=nloop, group=group, nadmm=nadmm)
        if self.verbose:
            for k, a in enumerate(vals):
                print(f"Accuracy of client {k + 1} on the test images: {100.0 * a:.2f} %")

    def step_time(self, phase: str, seconds: float, **context) -> None:
        self.log("step_time", {"phase": phase, "seconds": seconds}, **context)
        if self.verbose:
            ctx = " ".join(f"{k}={v}" for k, v in context.items())
            print(f"step_time phase={phase} {ctx} seconds={seconds:.4f}")

    def to_json(self) -> str:
        return json.dumps({"series": self.series, "first_nonfinite": self.first_nonfinite})

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename)."""
        path = os.path.abspath(path)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
