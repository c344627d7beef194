"""Velocity-Verlet integrators: NVE and Langevin NVT.

Port of ``uammd_tpu/integrators/verlet.py``:
- VerletNVE (reference: src/Integrator/VerletNVE.cu:174-189): two
  half-kicks around a drift, optional velocities to a target energy;
- VerletNVT::Basic (Basic.cu:87-115): velocity Verlet with friction
  -gamma v and noise of std sqrt(dt gamma T / m) in each half kick;
- VerletNVT::GronbechJensen (GronbechJensen.cu:20-62; Gronbech-Jensen &
  Farago, Mol. Phys. 2013).

Each is an ``Integrator`` of ``step(state, aux) -> (state, aux)`` over a
``force_fn(state, aux) -> (fev, aux)`` (see ``integrators.base``). Noise
comes from the state's ``torch.Generator`` on the state's device.
"""

from __future__ import annotations

import torch

from ..core.state import SimState, next_key
from ..device import device_vector
from .base import Integrator, advance_time, kinetic_energy


def _zero_z(arr, is2D):
    if not is2D:
        return arr
    return arr * device_vector((1.0, 1.0, 0.0), arr.dtype, arr.device)


def _normal(state: SimState, gen) -> torch.Tensor:
    return torch.randn((state.n, 3), generator=gen, dtype=state.dtype, device=state.device)


def initialize_velocities(state: SimState, temperature, is2D=False) -> SimState:
    """Maxwell-Boltzmann velocities at ``temperature`` with the net momentum
    removed (reference: Basic.cu initialVelocities)."""
    state, gen = next_key(state)
    m = state.get_mass()
    sigma = torch.sqrt(temperature / m)[:, None]
    v = sigma * _normal(state, gen)
    v = v - torch.mean(v * m[:, None], dim=0) / torch.mean(m)
    return state.replace(vel=_zero_z(v, is2D))


def nve(force_fn, dt: float, *, is2D: bool = False,
        initial_energy: float | None = None) -> Integrator:
    """Velocity Verlet NVE (reference: VerletNVE.cu:174-189).

    ``initial_energy``: when the state has no velocities, draw them and
    rescale so that the total energy is this (VerletNVE.cuh:38)."""

    def init(state, aux):
        if state.vel is None:
            if initial_energy is not None:
                state = initialize_velocities(state, 1.0, is2D)
                fev_e, aux = force_fn(state, aux)
                ke = kinetic_energy(state)
                pot_e = torch.sum(fev_e.energy) if fev_e.energy is not None else 0.0 * ke
                target_ke = torch.clamp(initial_energy - pot_e, min=1e-12)
                state = state.replace(
                    vel=state.vel * torch.sqrt(target_ke / torch.clamp(ke, min=1e-30)))
            else:
                state = state.replace(vel=torch.zeros_like(state.pos))
        fev, aux = force_fn(state, aux)
        return state.replace(force=fev.force), aux

    def step(state, aux):
        m = state.get_mass()[:, None]
        v = state.vel + 0.5 * dt * state.force / m
        state = state.replace(pos=state.pos + dt * _zero_z(v, is2D))
        fev, aux = force_fn(state, aux)
        v = v + 0.5 * dt * fev.force / m
        state = state.replace(vel=_zero_z(v, is2D), force=fev.force)
        return advance_time(state, dt), aux

    return Integrator(init=init, step=step)


def nvt_basic(force_fn, dt: float, temperature: float, friction: float = 1.0, *,
              is2D: bool = False) -> Integrator:
    """Langevin velocity Verlet, VerletNVT::Basic (Basic.cu:87-115): each
    half kick applies (f/m - gamma v) dt/2 plus noise of std
    sqrt(dt gamma T / m) per component."""

    def half_kick(state, gen):
        m = state.get_mass()[:, None]
        amp = torch.sqrt(dt * friction * temperature / m)
        noise = amp * _normal(state, gen)
        v = state.vel + (state.force / m - friction * state.vel) * (0.5 * dt) + noise
        return _zero_z(v, is2D)

    def init(state, aux):
        if state.vel is None:
            state = initialize_velocities(state, temperature, is2D)
        fev, aux = force_fn(state, aux)
        return state.replace(force=fev.force), aux

    def step(state, aux):
        state, gen = next_key(state)
        v = half_kick(state, gen)
        state = state.replace(pos=state.pos + dt * v, vel=v)
        fev, aux = force_fn(state, aux)
        state = state.replace(force=fev.force)
        state = state.replace(vel=half_kick(state, gen))
        return advance_time(state, dt), aux

    return Integrator(init=init, step=step)


def nvt_gronbech_jensen(force_fn, dt: float, temperature: float, friction: float = 1.0, *,
                        is2D: bool = False) -> Integrator:
    """Gronbech-Jensen & Farago 2013 Langevin Verlet (reference:
    GronbechJensen.cu:20-62); ``friction`` is a rate, gamma = friction m."""

    def init(state, aux):
        if state.vel is None:
            state = initialize_velocities(state, temperature, is2D)
        fev, aux = force_fn(state, aux)
        return state.replace(force=fev.force), aux

    gdt = 0.5 * friction * dt
    b = 1.0 / (1.0 + gdt)
    a = (1.0 - gdt) * b

    def step(state, aux):
        m = state.get_mass()[:, None]
        state, gen = next_key(state)
        # noise std sqrt(2 T m friction dt) per component
        amp = torch.sqrt(2.0 * temperature * friction * dt * m)
        noise = _zero_z(amp * _normal(state, gen), is2D)
        f0 = state.force
        x = state.pos + b * dt * state.vel + (0.5 * b * dt / m) * (dt * f0 + noise)
        v = a * state.vel + (0.5 * dt / m) * a * f0 + (b / m) * noise
        state = state.replace(pos=x, vel=_zero_z(v, is2D))
        fev, aux = force_fn(state, aux)
        v = state.vel + (0.5 * dt / m) * fev.force
        state = state.replace(vel=_zero_z(v, is2D), force=fev.force)
        return advance_time(state, dt), aux

    return Integrator(init=init, step=step)
