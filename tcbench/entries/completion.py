"""Completion cells: sweeps of one solver on the function tensor, from the
deployment's start, back to back.

The window drives what ``launch.complete.run_solver`` drives:
``core.completion.make_step``'s step, fenced by a device synchronisation,
then ``launch.complete.rmse`` (and for GGN the objective, and the damping
read back), as each sweep line of the CLI needs them. Set-up makes the
tensor and the initial factors on the card from the configuration's
``index_seed`` alone (the tensor's indices, its values' grids and the
factors, each from a stream of its own), so that every seed gives the
solver the same problem; the seed draws the ingest's shuffle, the order
in which the program holds the entries. It ingests them
(``data.pipeline.CompletionDataset``), builds the step and runs the
traffic's ``compare_sweeps`` first sweeps through the same call; their
factors, RMSE, objective and damping are the answers the reference checks.
The window carries on from there.
"""
from __future__ import annotations

import math
import types
from typing import Dict, List, Optional

import torch

from tcbench import gen
from tcbench.loop import free
from tcbench.reference import common as C

# the program span logged once a window step: the RMSE that each sweep reads
CALL_SPAN = "complete/rmse"


class Entry:
    END_TO_END = ("sweep_ms",)

    def __init__(self, cell):
        self.cell = cell
        c, t = cell.config, cell.traffic
        self.shape = tuple(c["shape"])
        self.nnz = int(c["nnz"])
        self.rank = int(c["rank"])
        self.algorithm = t["algorithm"]
        # what the program's step takes, and what the reference follows:
        # those, with the program's fixed inner counts
        self.settings = dict(t["settings"])
        self.ref_settings = dict(self.settings,
                                 **t.get("reference_settings", {}))
        self.compare = int(t["compare_sweeps"])
        self.ref = cell.reference
        self.attempted = self.failed = 0
        self.rows: List[int] = []
        self._prog = None
        self._answers: List[Dict] = []
        self._want: Optional[List[Dict]] = None
        self._wants: Dict[tuple, List[Dict]] = {}
        self._problem: Optional[C.Problem] = None

    # -- inputs --------------------------------------------------------------
    def inputs(self):
        dev, fixed = self.cell.device, self.cell.config["index_seed"]
        idx, vals = gen.function_tensor(
            self.shape, self.nnz, gen.device_generator(fixed, "tensor", dev),
            gen.device_generator(fixed, "values", dev))
        fs = gen.normal_factors(self.shape, self.rank,
                                gen.device_generator(fixed, "factors", dev))
        return idx, vals, fs

    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.completion import make_step
        from repro_torch.core.sparse_tensor import SparseTensor
        from repro_torch.data.pipeline import CompletionDataset
        from repro_torch.planner import PlannerConfig, set_default_config
        s, dev = self.settings, self.cell.device
        idx, vals, fs = self.inputs()
        self.rows = [int((torch.bincount(idx[:, d].long(), minlength=n) > 0)
                         .sum()) for d, n in enumerate(self.shape)]
        # ingest and the planner's dispatch read one bucket view, as the
        # CLI sets it
        set_default_config(PlannerConfig(block_rows=s["block_rows"]))
        raw = SparseTensor.from_coo(idx, vals, self.shape)
        del idx, vals
        ds = CompletionDataset(raw, gen.device_generator(self.cell.seed,
                                                         "ingest", dev),
                               block_rows=s["block_rows"])
        del raw
        state, step, get = make_step(self.algorithm, ds.tensor, ds.omega,
                                     fs, seed=self.cell.seed, **s)
        self._prog = types.SimpleNamespace(ds=ds, step=step, get=get,
                                           state=state, i=0)
        for _ in range(self.compare):
            out = self.sweep()
            out["factors"] = [f.detach().cpu().clone()
                              for f in self._prog.get(self._prog.state)]
            self._answers.append(out)

    def sweep(self) -> Dict:
        """One sweep and what the CLI's sweep line reads after it."""
        from repro_torch.core.completion.gcp import gcp_loss
        from repro_torch.core.losses import LOSSES
        from repro_torch.launch.complete import rmse
        p, span = self._prog, self.cell.tracer.span
        with span("tcbench.sweep"):
            p.state = p.step(p.i, p.state)
            if p.ds.tensor.device.type == "cuda":
                torch.cuda.synchronize()
        p.i += 1
        st, fs = p.ds.tensor, p.get(p.state)
        with span("tcbench.rmse"):
            out = {"rmse": rmse(st, fs)}
        if self.algorithm in ("gcp", "ggn"):
            with span("tcbench.objective"):
                out["objective"] = float(gcp_loss(
                    st, fs, LOSSES[self.settings["loss"]],
                    self.settings["lam"]))
        if hasattr(p.state, "damping"):
            out["damping"] = float(p.state.damping)
        return out

    def window_step(self) -> None:
        out = self.sweep()
        self.attempted += 1
        if not all(math.isfinite(v) for v in out.values()):
            self.failed += 1

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"sweep_ms": window_s * 1e3 / max(self.attempted, 1)}

    def work(self) -> Dict:
        return {"sweeps": self.attempted,
                "passes": self.cell.traffic["passes"], "nnz": self.nnz,
                "rank": self.rank, "rows": self.rows}

    def release(self) -> None:
        self._prog = None
        free()

    # -- the check -----------------------------------------------------------
    def problem(self, prec: C.Precision, keep: Optional[slice] = None):
        """The reference's view of the inputs, made again from the seed;
        ``keep`` takes a part of the entries (a planted fault)."""
        idx, vals, fs = self.inputs()
        if keep is not None:
            idx, vals = idx[keep], vals[keep]
        return C.Problem(idx, prec(vals), fs, self.shape)

    def answers(self, prec: Optional[C.Precision] = None,
                keep: Optional[slice] = None) -> List[Dict]:
        if prec is None:
            return self._answers
        return self.ref.follow(self.problem(prec, keep), self.ref_settings,
                               self.compare, prec)

    def numbers(self, got: List[Dict]) -> Dict[str, float]:
        """The numbers compared for ``got``; the reference follows the
        choices of ``got`` that it cannot tell from its own, so it runs
        once for each set of choices it is shown."""
        if self._problem is None:
            C.no_tf32()
            self._problem = self.problem(C.REFERENCE)
        key = tuple(g.get("damping") for g in got)
        if key not in self._wants:
            self._wants[key] = self.ref.follow(
                self._problem, self.ref_settings, self.compare, C.REFERENCE,
                program=got)
        self._want = self._wants[key]
        return self.ref.numbers(got, self._want, self._problem)
