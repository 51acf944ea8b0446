from .lattice import (
    C19, C7, CS, CS2, OPP19, OPP7, SMAGORINSKY_FACTOR, W19, W7,
    check_lattice_integrity, omega_from_nu, omega_t_from_alpha, tau_from_nu,
)
from .state import (
    DynParams, Forcing, LBMState, StepConfig,
    TYPE_E, TYPE_F, TYPE_S, TYPE_T,
    decode_ddf, encode_ddf, equilibrium_state, make_initial_state,
    storage_dtype,
)
from .reference import (
    equilibrium_f, equilibrium_g, make_multi_step, make_step, moments,
)
from .forcing import NudgeSpec, SpongeSpec, build_forcing

__all__ = [
    "C19", "C7", "CS", "CS2", "OPP19", "OPP7", "SMAGORINSKY_FACTOR", "W19", "W7",
    "check_lattice_integrity", "omega_from_nu", "omega_t_from_alpha", "tau_from_nu",
    "DynParams", "Forcing", "LBMState", "StepConfig",
    "TYPE_E", "TYPE_F", "TYPE_S", "TYPE_T",
    "decode_ddf", "encode_ddf", "equilibrium_state", "make_initial_state",
    "storage_dtype",
    "equilibrium_f", "equilibrium_g", "make_multi_step", "make_step", "moments",
    "NudgeSpec", "SpongeSpec", "build_forcing",
]
