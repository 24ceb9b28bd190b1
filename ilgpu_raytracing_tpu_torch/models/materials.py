"""Material model.

Mirrors the reference's 48-byte MaterialRecord (reference
MeshLoaderOBJ.cs:43-63) and the shading-mode constants
(Sphere.cs:3-16): LAMBERT=0, MIRROR=1, GLASS=2. Host side this is a plain
dataclass; committed scenes store materials as SoA arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SHADING_LAMBERT = 0
SHADING_MIRROR = 1
SHADING_GLASS = 2


@dataclasses.dataclass
class Material:
    kd: tuple[float, float, float] = (1.0, 1.0, 1.0)
    diffuse_tex: int = -1  # index into the scene texture table, -1 = none
    alpha_tex: int = -1
    alpha_cutoff: float = 0.5
    two_sided: bool = False
    shading: int = SHADING_LAMBERT
    ior: float = 1.0

    def validate(self) -> "Material":
        assert self.shading in (SHADING_LAMBERT, SHADING_MIRROR, SHADING_GLASS)
        return self


def materials_to_soa(mats: list[Material]) -> dict[str, np.ndarray]:
    """SoA arrays; a single default material is emitted for empty scenes so
    device shapes stay valid (the reference's alloc-or-1-element-dummy,
    Scene.cs:370-377)."""
    if not mats:
        mats = [Material()]
    return {
        "mat_kd": np.array([m.kd for m in mats], dtype=np.float32),
        "mat_diffuse_tex": np.array([m.diffuse_tex for m in mats], dtype=np.int32),
        "mat_alpha_tex": np.array([m.alpha_tex for m in mats], dtype=np.int32),
        "mat_alpha_cutoff": np.array([m.alpha_cutoff for m in mats], dtype=np.float32),
        "mat_two_sided": np.array(
            [1 if m.two_sided else 0 for m in mats], dtype=np.int32
        ),
        "mat_shading": np.array([m.shading for m in mats], dtype=np.int32),
        "mat_ior": np.array([m.ior for m in mats], dtype=np.float32),
    }
