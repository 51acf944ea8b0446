"""Simulation state and configuration pytrees.

Arrays are indexed [z, y, x] with x innermost (contiguous); vector
fields carry a leading component axis.  DDFs are stored in the perturbation
(DDF-shifted) form: f_stored = f - w_i, so magnitudes stay near zero and
compress well to 16-bit storage (reference: kernel.cpp:1016-1100).

Storage codec: `f16` mirrors the reference's FP16S (range-shifted IEEE half,
scale 2^15 — reference lbm.cpp:707-710), `bf16` is the wide-range 2-byte
option, `f32` is exact.  All arithmetic is fp32 regardless of storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Cell-type bitmask (matches the reference flag contract, defines.hpp:52-59).
TYPE_S = 0x01  # solid (bounce-back)
TYPE_E = 0x02  # equilibrium boundary (fixed rho/u)
TYPE_T = 0x04  # fixed-temperature cell
TYPE_F = 0x08  # fluid marker (informational)

FP16_SCALE = 32768.0
FP16_INV_SCALE = 1.0 / 32768.0

_STORAGE_DTYPES = {
    "f32": jnp.float32,
    "f16": jnp.float16,
    "bf16": jnp.bfloat16,
    "fp16c": jnp.uint16,   # 1-4-11 custom float carried as raw bit patterns
}


def storage_dtype(name: str):
    return _STORAGE_DTYPES[name]


def encode_fp16c(x) -> "jnp.ndarray":
    """fp32 -> FP16C (1-4-11, exp-15) bit patterns, RNE with denormals.

    The reference's default DDF compression (defines.hpp:14,
    kernel.cpp:864-875 float_to_half_custom): range +-1.9995, smallest
    denormal +-2.98e-8; the 11-bit mantissa halves quantization error vs
    IEEE half for the near-zero DDF-shifted populations.
    Accepts numpy or jnp arrays (module dispatch keeps one formula).
    """
    xp = jnp if isinstance(x, jnp.ndarray) else np
    if xp is jnp:
        b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    else:
        b = np.asarray(x, np.float32).view(np.int32)
    b = b + 0x00000800                       # round-to-nearest-even
    e = (b >> 23) & 0xFF
    m = b & 0x007FFFFF
    sgn = (b >> 16) & 0x8000
    norm = (((e - 112) << 11) & 0x7800) | (m >> 12)
    den = (((0x007FF800 + m) >> xp.clip(124 - e, 0, 31)) + 1) >> 1
    h = sgn | xp.where(e > 112, norm, xp.where(e > 100, den, 0))
    # overflow saturates to the largest finite FP16C value (reference
    # utilities.hpp float_to_half_custom: (e > 127) * 0x7FFF term) — without
    # this, |x| >= 2 wraps to near-zero garbage instead of clamping
    h = xp.where(e > 127, sgn | 0x7FFF, h)
    return h.astype(xp.uint16)


def decode_fp16c(x) -> "jnp.ndarray":
    """FP16C bit patterns -> fp32 (reference half_to_float_custom)."""
    xp = jnp if isinstance(x, jnp.ndarray) else np
    b = x.astype(xp.int32)
    e = (b >> 11) & 0xF
    m = (b & 0x7FF) << 12
    # leading-zero count of the denormal mantissa via the float32 exponent
    # of float(m) — the reference's "evil log2 bit hack"
    if xp is jnp:
        mf = jax.lax.bitcast_convert_type(m.astype(jnp.float32), jnp.int32)
    else:
        mf = m.astype(np.float32).view(np.int32)
    v = (mf >> 23) & 0xFF
    sgn = (b & 0x8000) << 16
    norm = ((e + 112) << 23) | m
    den = ((v - 37) << 23) | ((m << xp.clip(150 - v, 0, 31)) & 0x007FF000)
    bits = sgn | xp.where(e != 0, norm, xp.where(m != 0, den, 0))
    if xp is jnp:
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return bits.view(np.float32)


def encode_ddf(x: jnp.ndarray, storage: str) -> jnp.ndarray:
    """fp32 DDF -> storage representation."""
    if storage == "f32":
        return x
    if storage == "f16":
        return (x * FP16_SCALE).astype(jnp.float16)
    if storage == "bf16":
        return x.astype(jnp.bfloat16)
    if storage == "fp16c":
        return encode_fp16c(x)
    raise ValueError(f"unknown storage {storage!r}")


def decode_ddf(x: jnp.ndarray, storage: str) -> jnp.ndarray:
    """storage representation -> fp32 DDF."""
    if storage == "f32":
        return x
    if storage == "f16":
        return x.astype(jnp.float32) * FP16_INV_SCALE
    if storage == "bf16":
        return x.astype(jnp.float32)
    if storage == "fp16c":
        return decode_fp16c(x)
    raise ValueError(f"unknown storage {storage!r}")


class LBMState(NamedTuple):
    """One complete lattice state. `gi`/`T` are None unless thermal."""

    fi: jnp.ndarray             # (19, Z, Y, X) storage dtype, DDF-shifted
    rho: jnp.ndarray            # (Z, Y, X) f32
    u: jnp.ndarray              # (3, Z, Y, X) f32
    flags: jnp.ndarray          # (Z, Y, X) uint8
    gi: Optional[jnp.ndarray] = None   # (7, Z, Y, X) storage dtype, DDF-shifted
    T: Optional[jnp.ndarray] = None    # (Z, Y, X) f32


class DynParams(NamedTuple):
    """Per-step dynamic parameters (traced; changing them never recompiles)."""

    force: jnp.ndarray           # (3,) global volume force (gravity), f32
    omega_coriolis: jnp.ndarray  # (3,) Coriolis rotation vector in lattice units


class Forcing(NamedTuple):
    """Precomputed spatial forcing fields (buffer nudging + top sponge).

    Built once per case by `forcing.build_forcing`; zeros when disabled.
    """

    nudge_sigma: Optional[jnp.ndarray] = None   # (Z, Y, X) f32: w_buf/tau, 0 outside band
    nudge_face: Optional[jnp.ndarray] = None    # (Z, Y, X) int8: 0=w,1=e,2=s,3=n,4=top
    nudge_vertical: bool = False
    sponge_sigma_z: Optional[jnp.ndarray] = None  # (Z,) f32 profile, 0 below sponge


@dataclass(frozen=True)
class StepConfig:
    """Static (compile-time) solver configuration."""

    omega: float                  # SRT relaxation rate 1/tau = 1/(3 nu + 0.5)
    collision: str = "srt"        # "srt" | "trt"
    subgrid: bool = True          # Smagorinsky-Lilly LES
    thermal: bool = False         # D3Q7 temperature sub-lattice
    omega_t: float = 1.0          # thermal relaxation rate 1/(2 alpha + 0.5)
    beta: float = 0.0             # Boussinesq expansion coefficient (lattice)
    t_avg: float = 1.0            # reference temperature (lattice)
    storage: str = "f32"          # DDF storage codec
    equilibrium_boundaries: bool = True
    # Static VOLUME_FORCE analog (reference defines.hpp compiles forcing in
    # or out).  False compiles the Guo half-step/forcing terms OUT of both
    # tiers — the builders refuse nudge/sponge/thermal configurations, and
    # dyn.force / dyn.omega_coriolis are IGNORED (pass zeros; the run modes
    # guarantee this via _specialize_force, which only turns forcing off
    # when Coriolis is zero too).  Numerics are identical (the Guo terms are
    # exactly 0 there); it only removes dead arithmetic from the
    # bandwidth-bound step.
    volume_force: bool = True
    # LES wall model for horizontal solid faces (ground, roofs): upward DDFs
    # whose pull source is solid BELOW with a fluid in-plane neighbor reflect
    # SPECULARLY (free-slip) instead of bouncing back, and the first fluid
    # cell above such a face receives the Schumann log-law shear stress
    # F = -wall_cd * rho * |u_h| * u_h  (per lattice step; wall_cd =
    # [kappa / ln(z1/z0)]^2 with z1 = cell/2).  This removes the stair-step
    # bounce-back's artificial z0 ~ O(cell) roughness and replaces it with
    # the physical aerodynamic roughness — essential for coarse-cell urban
    # ABL runs (AIJ guideline "horizontal homogeneity" requirement).  The
    # reference has no wall model (its ground is plain TYPE_S bounce-back,
    # setup.cpp:5948-5955); this is a beyond-parity accuracy feature.
    # Vertical building faces keep bounce-back (resolved form drag) unless
    # wall_sides is on.
    wall_model: bool = False
    wall_cd: float = 0.0
    # Wall model for VERTICAL solid faces (building walls): in-plane DDFs
    # whose pull source is solid to the side reflect specularly about that
    # face (x or y mirror) when the tangential partner cell is fluid, and
    # the first fluid cell beside such a face receives the tangential
    # Schumann stress with wall_cd_sides (0 = pure free-slip sides).
    # Rationale: at 2-4 m cells, stair-step bounce-back imposes an
    # artificial sand-grain roughness ~ O(cell) on walls that are
    # hydraulically smooth in reality (and in the AIJ wind tunnel's wood
    # models), over-damping street-canyon flow.  Normal-direction blockage
    # (form drag) is unchanged — only the tangential momentum sink is
    # replaced by the modeled stress.
    wall_sides: bool = False
    wall_cd_sides: float = 0.0

    def __post_init__(self):
        assert self.collision in ("srt", "trt")
        assert self.storage in _STORAGE_DTYPES
        if self.wall_model:
            assert self.volume_force, "wall_model needs volume_force=True"
            assert self.wall_cd > 0.0, "wall_model needs wall_cd > 0"
        if self.wall_sides:
            assert self.wall_model, "wall_sides extends wall_model"
            assert self.wall_cd_sides >= 0.0


def _np_storage_dtype(storage: str):
    return {"f32": np.float32, "f16": np.float16, "bf16": None,
            "fp16c": np.uint16}[storage]


def make_initial_state(
    shape,  # (Z, Y, X)
    *,
    config: StepConfig,
    rho: Optional[np.ndarray] = None,
    u: Optional[np.ndarray] = None,
    flags: Optional[np.ndarray] = None,
    T: Optional[np.ndarray] = None,
) -> LBMState:
    """Initialize DDFs at equilibrium from (rho, u[, T]) — the analog of the
    reference initialize kernel (kernel.cpp:1370).

    Equilibria are built direction-by-direction on the host so the transient
    footprint stays one fp32 plane-set instead of a full 19-channel fp32
    lattice (matters for 10^8-cell grids).
    """
    from .lattice import C19, C7, W19, W7

    Z, Y, X = shape
    rho_h = np.asarray(rho if rho is not None else np.ones(shape), dtype=np.float32)
    u_h = np.asarray(u if u is not None else np.zeros((3, *shape)), dtype=np.float32)
    flags_h = np.asarray(flags if flags is not None else np.zeros(shape), dtype=np.uint8)

    import ml_dtypes

    np_dt = _np_storage_dtype(config.storage) or ml_dtypes.bfloat16
    scale = FP16_SCALE if config.storage == "f16" else 1.0
    to_storage = (encode_fp16c if config.storage == "fp16c"
                  else (lambda a: a.astype(np_dt)))

    rhom1 = rho_h - 1.0
    c3 = -3.0 * (u_h[0] ** 2 + u_h[1] ** 2 + u_h[2] ** 2)
    fi_h = np.empty((19, Z, Y, X), dtype=np_dt)
    for d in range(19):
        cx, cy, cz = (int(v) for v in C19[d])
        w = float(W19[d])
        if cx == 0 and cy == 0 and cz == 0:
            feq = w * (rhom1 + rho_h * (0.5 * c3))
        else:
            cu = 3.0 * (cx * u_h[0] + cy * u_h[1] + cz * u_h[2])
            feq = w * (rhom1 + rho_h * (0.5 * (cu * cu + c3) + cu))
        fi_h[d] = to_storage((feq * scale).astype(np.float32))

    gi = None
    T_a = None
    if config.thermal:
        T_h = np.asarray(T if T is not None else np.ones(shape), dtype=np.float32)
        gi_h = np.empty((7, Z, Y, X), dtype=np_dt)
        for d in range(7):
            cx, cy, cz = (int(v) for v in C7[d])
            w = float(W7[d])
            if d == 0:
                geq = w * (T_h - 1.0)
            else:
                cu = cx * u_h[0] + cy * u_h[1] + cz * u_h[2]
                geq = w * (T_h - 1.0) + 4.0 * w * T_h * cu
            gi_h[d] = to_storage((geq * scale).astype(np.float32))
        gi = jnp.asarray(gi_h)
        T_a = jnp.asarray(T_h)

    return LBMState(
        fi=jnp.asarray(fi_h),
        rho=jnp.asarray(rho_h),
        u=jnp.asarray(u_h),
        flags=jnp.asarray(flags_h),
        gi=gi,
        T=T_a,
    )


def equilibrium_state(
    shape,  # (Z, Y, X)
    *,
    config: StepConfig,
    rho=None,
    u=None,
    flags=None,
    T=None,
) -> LBMState:
    """Traceable `make_initial_state`: equilibrium DDFs built ON DEVICE.

    Same math as make_initial_state (reference initialize kernel,
    kernel.cpp:1370) expressed in jnp so it can run under `jax.jit`: the host
    path pays seconds of numpy per 10^7 cells plus a full 19-channel DDF
    upload (~38 B/cell); this path uploads only the (rho, u, flags[, T])
    inputs (~17 B/cell — or nothing when they are built in-trace) and
    computes feq on the device.  XLA fuses each direction's feq into its encode, so the
    transient footprint stays one fp32 lattice per direction.
    """
    from .lattice import C19, C7, W19, W7

    shape = tuple(int(v) for v in shape)
    rho_j = (jnp.ones(shape, jnp.float32) if rho is None
             else jnp.asarray(rho, jnp.float32))
    u_j = (jnp.zeros((3, *shape), jnp.float32) if u is None
           else jnp.asarray(u, jnp.float32))
    flags_j = (jnp.zeros(shape, jnp.uint8) if flags is None
               else jnp.asarray(flags, jnp.uint8))

    rhom1 = rho_j - 1.0
    c3 = -3.0 * (u_j[0] ** 2 + u_j[1] ** 2 + u_j[2] ** 2)
    fis = []
    for d in range(19):
        cx, cy, cz = (int(v) for v in C19[d])
        w = float(W19[d])
        if cx == 0 and cy == 0 and cz == 0:
            feq = w * (rhom1 + rho_j * (0.5 * c3))
        else:
            cu = 3.0 * (cx * u_j[0] + cy * u_j[1] + cz * u_j[2])
            feq = w * (rhom1 + rho_j * (0.5 * (cu * cu + c3) + cu))
        fis.append(encode_ddf(feq, config.storage))
    fi = jnp.stack(fis)

    gi = None
    T_a = None
    if config.thermal:
        T_j = (jnp.ones(shape, jnp.float32) if T is None
               else jnp.asarray(T, jnp.float32))
        gis = []
        for d in range(7):
            cx, cy, cz = (int(v) for v in C7[d])
            w = float(W7[d])
            if d == 0:
                geq = w * (T_j - 1.0)
            else:
                cu = cx * u_j[0] + cy * u_j[1] + cz * u_j[2]
                geq = w * (T_j - 1.0) + 4.0 * w * T_j * cu
            gis.append(encode_ddf(geq, config.storage))
        gi = jnp.stack(gis)
        T_a = T_j

    return LBMState(fi=fi, rho=rho_j, u=u_j, flags=flags_j, gi=gi, T=T_a)
