"""Sampler plugins as functional state machines (port of the JAX package's
``samplers/__init__.py``: the base sampler, ``independent`` and
``correlated``), bitwise equal to it draw for draw.

Sampler state is a plain tuple of tensors and ints; every draw returns
(value, new state):

  * main stream : PCG32 seeded TEA(base_seed + seed, lane)          (sampler.cpp:115-135)
  * time stream : PCG32 seeded TEA(base_seed + seed + 1, lane//Tc)  (correlated.cpp:44-59)
  * path stream : PCG32 seeded TEA(base_seed + seed + 2, lane//Pc)
  * per-sequence permutation seed                                    (sampler.cpp:85-92)
  * next_1d_time strategies                                          (correlated.cpp:92-153)
  * next_1d_correlate: draws BOTH streams, selects by `correlate`    (correlated.cpp:156-161)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.properties import Properties, register_plugin
from ..core.rng import (MASK32, PCG32State, pcg32_seed_wavefront,
                        pcg32_next_f32, sample_tea_32, permute_kensler)

# ETimeSampling (reference include/mitsuba/render/sampler.h:27-34)
TIME_UNIFORM = 0
TIME_STRATIFIED = 1
TIME_ANTITHETIC = 2
TIME_ANTITHETIC_MIRROR = 3
TIME_PERIODIC = 4

TIME_SAMPLING_METHODS = {
    "uniform": TIME_UNIFORM,
    "stratified": TIME_STRATIFIED,
    "antithetic": TIME_ANTITHETIC,
    "antithetic_mirror": TIME_ANTITHETIC_MIRROR,
    "periodic": TIME_PERIODIC,
}


class SamplerState(NamedTuple):
    rng: PCG32State                 # main stream (per lane)
    rng_time: PCG32State            # correlated time stream
    rng_path: PCG32State            # correlated path stream
    permutation_seed: torch.Tensor  # (N,) per-sequence seed words
    sample_index: int               # pass index (global across passes)
    dimension_index: int
    lane: torch.Tensor              # (N,) int64 global lane ids
    lane0: int                      # first global lane of this window
    seed_value: int                 # base seed of this render (32-bit)


class Sampler:
    """Host-side configuration; device state comes from ``seed``."""

    def __init__(self, props: Properties):
        self.id = props.id
        self.sample_count = props.get_int("sample_count", 4)
        self.base_seed = props.get_int("seed", 0)
        self.samples_per_wavefront = 1
        self.time_correlate_number = 1
        self.path_correlate_number = 1

    def set_sample_count(self, spp: int):
        self.sample_count = spp

    def set_samples_per_wavefront(self, spw: int):
        if self.sample_count % spw != 0:
            raise RuntimeError(
                "sample_count must be a multiple of samples_per_wavefront")
        self.samples_per_wavefront = spw

    def _streams(self, seed_value: int, lane):
        tc = max(int(self.time_correlate_number), 1)
        pc = max(int(self.path_correlate_number), 1)
        return (pcg32_seed_wavefront(seed_value, lane, 0),
                pcg32_seed_wavefront(seed_value, lane // tc, 1),
                pcg32_seed_wavefront(seed_value, lane // pc, 2))

    def _perm_seed(self, lane, seed_u: int):
        spw = self.samples_per_wavefront
        sequence_idx = spw * (lane // spw)
        perm_seed, _ = sample_tea_32(
            torch.full_like(lane, self.base_seed & MASK32),
            (sequence_idx + seed_u) & MASK32)
        return perm_seed

    def seed(self, seed: int, wavefront_size: int, lane0: int = 0,
             device=None) -> SamplerState:
        """Seed lanes [lane0, lane0 + wavefront_size) of a (possibly
        larger) logical wavefront: per-lane streams depend only on the
        global lane index (reference sampler.cpp:115-135)."""
        lane = lane0 + torch.arange(wavefront_size, dtype=torch.int64,
                                    device=device)
        seed_value = (self.base_seed + seed) & MASK32
        rng, rng_time, rng_path = self._streams(seed_value, lane)
        return SamplerState(rng, rng_time, rng_path,
                            self._perm_seed(lane, seed & MASK32), 0, 0,
                            lane, lane0, seed_value)

    def advance(self, state: SamplerState) -> SamplerState:
        """Next pass: fresh streams from (seed, pass index, lane), with the
        sample index global across passes (see the JAX package's
        ``Sampler.advance``)."""
        idx = state.sample_index + 1
        sv = (state.seed_value + idx * 0x9E3779B9) & MASK32
        rng, rng_time, rng_path = self._streams(sv, state.lane)
        return state._replace(rng=rng, rng_time=rng_time, rng_path=rng_path,
                              sample_index=idx, dimension_index=0)

    def advance_window(self, state: SamplerState) -> SamplerState:
        """Next window of the global wavefront (strip passes): the seed
        stays, the lane ids shift, so every stream is what one giant
        wavefront would have produced for those lanes."""
        n = state.lane.shape[0]
        lane = state.lane + n
        rng, rng_time, rng_path = self._streams(state.seed_value, lane)
        seed_u = (state.seed_value - self.base_seed) & MASK32
        return SamplerState(rng, rng_time, rng_path,
                            self._perm_seed(lane, seed_u), 0, 0, lane,
                            state.lane0 + n, state.seed_value)

    def current_sample_index(self, state: SamplerState):
        """reference sampler.cpp:94-103."""
        spw = self.samples_per_wavefront
        return (state.sample_index * spw + state.lane % spw) & MASK32

    # -- draws ----------------------------------------------------------------
    def next_1d(self, state, active=None):
        v, rng = pcg32_next_f32(state.rng, active)
        return v, state._replace(rng=rng)

    def next_2d(self, state, active=None):
        f1, state = self.next_1d(state, active)
        f2, state = self.next_1d(state, active)
        return (f1, f2), state

    def next_1d_time(self, state, active=None, strategy=TIME_UNIFORM,
                     antithetic_shift=0.0, stratified_interval=False):
        # base default (sampler.h:131): plain next_1d, unmasked
        v, rng = pcg32_next_f32(state.rng, None)
        return v, state._replace(rng=rng)

    def next_1d_correlate(self, state, active=None, correlate=None):
        return self.next_1d(state, active)

    def next_2d_correlate(self, state, active=None, correlate=None):
        return self.next_2d(state, active)


@register_plugin("sampler", "independent")
class IndependentSampler(Sampler):
    pass


@register_plugin("sampler", "correlated")
class CorrelatedSampler(Sampler):
    """Temporal random replay (reference src/samplers/correlated.cpp)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.time_correlate_number = props.get_int("time_correlate_number", 2)
        self.path_correlate_number = props.get_int(
            "path_correlate_number", self.time_correlate_number)

    def next_1d_time(self, state, active=None, strategy=TIME_UNIFORM,
                     antithetic_shift=0.0, stratified_interval=False):
        # (reference correlated.cpp:92-153)
        if strategy == TIME_UNIFORM:
            v, rng = pcg32_next_f32(state.rng, active)
            return v, state._replace(rng=rng)

        sample_indices = self.current_sample_index(state)
        tc = int(self.time_correlate_number)

        if strategy == TIME_STRATIFIED:
            r, rng = pcg32_next_f32(state.rng, active)
            state = state._replace(rng=rng)
        else:
            r, rng_time = pcg32_next_f32(state.rng_time, active)
            state = state._replace(rng_time=rng_time)

        if stratified_interval:
            n_stratum = self.sample_count // tc
            if strategy == TIME_STRATIFIED:
                perm = []
                for _ in range(2):
                    perm_seed = ((state.permutation_seed
                                  + state.dimension_index) & MASK32)
                    state = state._replace(
                        dimension_index=state.dimension_index + 1)
                    perm.append(permute_kensler(sample_indices // tc,
                                                n_stratum, perm_seed, active))
                p = torch.where(sample_indices % tc != 0, perm[0], perm[1])
                r = (p.to(r.dtype) + r) / n_stratum
            else:
                r = ((sample_indices // tc).to(r.dtype) + r) / n_stratum

        rem = sample_indices % tc
        if strategy == TIME_STRATIFIED:
            return (rem.to(r.dtype) + r) / tc, state
        if strategy == TIME_ANTITHETIC:
            if tc == 2:
                return torch.where(rem != 1, r, r + antithetic_shift), state
            return r + rem.to(r.dtype) / tc, state
        if strategy == TIME_ANTITHETIC_MIRROR:
            return torch.where(rem != 1, r, 1.0 - r + antithetic_shift), state
        if strategy == TIME_PERIODIC:
            return r + rem.to(r.dtype) / tc, state
        return r, state

    def next_1d_correlate(self, state, active=None, correlate=None):
        # both streams always advance (reference correlated.cpp:156-161)
        r1, rng_path = pcg32_next_f32(state.rng_path, active)
        r2, rng = pcg32_next_f32(state.rng, active)
        state = state._replace(rng=rng, rng_path=rng_path)
        if correlate is None:
            return r2, state
        if isinstance(correlate, bool):
            return (r1 if correlate else r2), state
        return torch.where(correlate, r1, r2), state

    def next_2d_correlate(self, state, active=None, correlate=None):
        f1, state = self.next_1d_correlate(state, active, correlate)
        f2, state = self.next_1d_correlate(state, active, correlate)
        return (f1, f2), state


__all__ = [
    "Sampler", "SamplerState", "IndependentSampler", "CorrelatedSampler",
    "TIME_UNIFORM", "TIME_STRATIFIED", "TIME_ANTITHETIC",
    "TIME_ANTITHETIC_MIRROR", "TIME_PERIODIC", "TIME_SAMPLING_METHODS",
]
