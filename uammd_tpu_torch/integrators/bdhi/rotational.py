"""Rotational BDHI: Euler-Maruyama with torques and quaternion orientations.

Port of ``uammd_tpu/integrators/bdhi/rotational.py`` (reference:
src/Integrator/BDHI/BDHI_FCM.cuh forwardTime, utils/quaternion.cuh:15):

    dX   = M_tt F dt + M_tr T dt + sqrt(2 kT dt) (B dW)_trans
    dPhi = M_rt F dt + M_rr T dt + sqrt(2 kT dt) (B dW)_rot
    dir <- exp(dPhi / 2) dir

The coupled mobility and its fluctuation come from one FCM spectral pass
(``FCM.compute_mf_bdw_torques``; at T = 0
``compute_hydrodynamic_displacements``). Forces and torques come from
``force_torque_fn(state, aux) -> (force [N, 3], torque [N, 3], aux)``.
"""

from __future__ import annotations

import math

import torch

from ...core import quaternion as quat
from ...core.state import next_key
from ..base import Integrator, advance_time


def bdhi_fcm_rotational(force_torque_fn, fcm, dt: float, temperature: float = 0.0) -> Integrator:
    """Euler-Maruyama over (pos, dir) with the FCM grand mobility."""

    def init(state, aux):
        if state.dir is None:
            state = state.replace(dir=quat.identity(state.n, state.dtype, state.device))
        if state.force is None:
            state = state.replace(force=torch.zeros_like(state.pos))
        if state.torque is None:
            state = state.replace(torque=torch.zeros_like(state.pos))
        return state, aux

    def step(state, aux):
        force, torque, aux = force_torque_fn(state, aux)
        if temperature > 0:
            state, gen = next_key(state)
            v, w = fcm.compute_mf_bdw_torques(state.pos, force, torque, gen,
                                              math.sqrt(2.0 * temperature / dt))
        else:
            v, w = fcm.compute_hydrodynamic_displacements(state.pos, force, torque)
        new_dir = quat.apply_rotation(state.dir, dt * w)
        return advance_time(state.replace(pos=state.pos + dt * v, dir=new_dir, force=force,
                                          torque=torque), dt), aux

    return Integrator(init=init, step=step)
