"""Cross-frame render state (port of runtime/framestate.py).

Reservoir ping-pong buffers, TAA history and progressive accumulation in
one dataclass carried through the frame step; the ping-pong is a host-side
swap of fields. `save`/`load` read and write the JAX package's npz format.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs

_RES_FIELDS = ("L", "wi", "pdf", "w", "w_sum", "m", "light_id", "W")


@dataclasses.dataclass
class FrameState:
    res_prev: Reservoirs  # read-only this frame (low-res N)
    res_cur: Reservoirs  # being overwritten this frame
    taa_color: torch.Tensor  # (outN,) int64 holding uint32 packed history
    taa_obj: torch.Tensor  # (outN,) i32
    taa_valid: bool
    accum: torch.Tensor  # (lowN,3) f32 progressive accumulation
    accum_count: int

    @staticmethod
    def create(low_n: int, out_n: int, device="cuda") -> "FrameState":
        return FrameState(
            res_prev=Reservoirs.empty(low_n, device),
            res_cur=Reservoirs.empty(low_n, device),
            taa_color=torch.zeros((out_n,), dtype=torch.int64, device=device),
            taa_obj=torch.full((out_n,), -1, dtype=torch.int32, device=device),
            taa_valid=False,
            accum=torch.zeros((low_n, 3), dtype=torch.float32, device=device),
            accum_count=0,
        )

    def swapped_reservoirs(self) -> "FrameState":
        return dataclasses.replace(self, res_prev=self.res_cur, res_cur=self.res_prev)

    # ---- checkpoint / resume (the JAX package's npz keys) ----

    def save(self, path: str) -> None:
        flat = {}
        for p in ("res_prev", "res_cur"):
            res = getattr(self, p)
            for k in _RES_FIELDS:
                flat[f"{p}_{k}"] = getattr(res, k).cpu().numpy()
        flat["taa_color"] = self.taa_color.cpu().numpy().astype(np.uint32)
        flat["taa_obj"] = self.taa_obj.cpu().numpy()
        flat["taa_valid"] = np.asarray(bool(self.taa_valid))
        flat["accum"] = self.accum.cpu().numpy()
        flat["accum_count"] = np.asarray(int(self.accum_count), np.int32)
        np.savez(path, **flat)

    @staticmethod
    def load(path: str, device="cuda") -> "FrameState":
        z = np.load(path)
        t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        def mk(p):
            # snapshots written before the W slot existed load with W = 0
            n = z[p + "_pdf"].shape[0]
            w_cap = z[p + "_W"] if p + "_W" in z.files else np.zeros((n,), np.float32)
            return Reservoirs(
                L=t(z[p + "_L"]), wi=t(z[p + "_wi"]), pdf=t(z[p + "_pdf"]),
                w=t(z[p + "_w"]), w_sum=t(z[p + "_w_sum"]),
                m=t(z[p + "_m"], torch.int32),
                light_id=t(z[p + "_light_id"], torch.int32), W=t(w_cap),
            )

        return FrameState(
            res_prev=mk("res_prev"), res_cur=mk("res_cur"),
            taa_color=t(z["taa_color"].astype(np.int64)),
            taa_obj=t(z["taa_obj"], torch.int32),
            taa_valid=bool(z["taa_valid"]),
            accum=t(z["accum"]),
            accum_count=int(z["accum_count"]),
        )
