"""Sampler plugins as functional state machines (port of the JAX package's
``samplers/__init__.py``: the base sampler, ``independent``,
``correlated``, ``timestratified``, ``stratified``, ``multijitter``,
``ldsampler`` and ``orthogonal``), bitwise equal to it draw for draw.

Sampler state is a plain tuple of tensors and ints; every draw returns
(value, new state):

  * main stream : PCG32 seeded TEA(base_seed + seed, lane)          (sampler.cpp:115-135)
  * time stream : PCG32 seeded TEA(base_seed + seed + 1, lane//Tc)  (correlated.cpp:44-59)
  * path stream : PCG32 seeded TEA(base_seed + seed + 2, lane//Pc)
  * per-sequence permutation seed                                    (sampler.cpp:85-92)
  * next_1d_time strategies                                          (correlated.cpp:92-153)
  * next_1d_correlate: draws BOTH streams, selects by `correlate`    (correlated.cpp:156-161)
  * stratified families: Kensler-permuted strata with jitter, the
    (0,2)-sequence and orthogonal arrays, indexed by the global sample
    index and the dimension                    (timestratified.cpp,
    stratified.cpp, multijitter.cpp, ldsampler.cpp, orthogonal.cpp)

Every 32-bit product is taken mod 2^32 with ``_mul32_lo``: the words live
in int64 tensors, where a plain ``*`` would carry past 32 bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.properties import Properties, register_plugin
from ..core.rng import (MASK32, PCG32State, pcg32_seed_wavefront,
                        pcg32_next_f32, sample_tea_32, permute_kensler,
                        _mul32_lo)

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
        self.jitter = True

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


class _JitteredStrata(Sampler):
    """Shared by the Kensler-stratified samplers: the next dimension's
    permutation seed, and the jitter draw (0.5 without jitter)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.jitter = props.get_bool("jitter", True)

    def _next_dim(self, state):
        """(sample indices, this dimension's permutation seed, state with
        the dimension advanced)."""
        idx = self.current_sample_index(state)
        perm_seed = (state.permutation_seed + state.dimension_index) & MASK32
        return idx, perm_seed, state._replace(
            dimension_index=state.dimension_index + 1)

    def _jitter(self, state, active):
        if self.jitter:
            j, rng = pcg32_next_f32(state.rng, active)
            return j, state._replace(rng=rng)
        return 0.5, state

    def _jitter_2d(self, state, active):
        if self.jitter:
            jx, rng = pcg32_next_f32(state.rng, active)
            jy, rng = pcg32_next_f32(rng, active)
            return jx, jy, state._replace(rng=rng)
        return 0.5, 0.5, state

    def _stratum_1d(self, state, active, scramble: int = None):
        """The jittered point of the sample's permuted stratum among
        ``sample_count``; ``scramble`` multiplies the permutation seed."""
        idx, perm_seed, state = self._next_dim(state)
        if scramble is not None:
            perm_seed = _mul32_lo(perm_seed, scramble)
        p = permute_kensler(idx, self.sample_count, perm_seed, active)
        j, state = self._jitter(state, active)
        return (p.to(torch.float32) + j) / self.sample_count, state


@register_plugin("sampler", "timestratified")
class TimeStratifiedSampler(_JitteredStrata):
    """Kensler-permuted stratified time (reference
    src/samplers/timestratified.cpp:117-130): sample k of a pixel's
    ``sample_count`` takes the time stratum of its permuted index."""

    def next_1d_time(self, state, active=None, strategy=TIME_UNIFORM,
                     antithetic_shift=0.0, stratified_interval=False):
        return self._stratum_1d(state, active)


@register_plugin("sampler", "stratified")
class StratifiedSampler(_JitteredStrata):
    """2D-stratified sampler (reference src/samplers/stratified.cpp):
    Kensler-permuted stratum order with jitter; 2D draws on a square grid,
    so ``sample_count`` rounds up to a square."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self._update_resolution()

    def _update_resolution(self):
        r = 1
        while r * r < self.sample_count:
            r += 1
        self.resolution = r
        self.sample_count = r * r

    def set_sample_count(self, spp: int):
        self.sample_count = spp
        self._update_resolution()

    def next_1d(self, state, active=None):
        return self._stratum_1d(state, active)

    def next_2d(self, state, active=None):
        idx, perm_seed, state = self._next_dim(state)
        p = permute_kensler(idx, self.sample_count, perm_seed, active)
        res = self.resolution
        y = p // res
        x = p - y * res
        jx, jy, state = self._jitter_2d(state, active)
        inv = 1.0 / res
        return ((x.to(torch.float32) + jx) * inv,
                (y.to(torch.float32) + jy) * inv), state


@register_plugin("sampler", "multijitter")
class MultijitterSampler(_JitteredStrata):
    """Correlated multi-jittered sampler (reference
    src/samplers/multijitter.cpp, Kensler 2013) on an rx x ry grid."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self._update_resolution()

    def _update_resolution(self):
        rx = max(1, int(math.sqrt(self.sample_count)))
        while rx * rx < self.sample_count:
            rx += 1
        ry = (self.sample_count + rx - 1) // rx
        self.res_x, self.res_y = rx, ry
        self.sample_count = rx * ry

    def set_sample_count(self, spp: int):
        self.sample_count = spp
        self._update_resolution()

    def next_1d(self, state, active=None):
        return self._stratum_1d(state, active, scramble=0x45FBE943)

    def next_2d(self, state, active=None):
        idx, perm_seed, state = self._next_dim(state)
        s = permute_kensler(idx, self.sample_count,
                            _mul32_lo(perm_seed, 0x51633E2D), active)
        rx, ry = self.res_x, self.res_y
        y = s // rx
        x = s - y * rx
        sx = permute_kensler(x, rx, _mul32_lo(perm_seed, 0x68BC21EB), active)
        sy = permute_kensler(y, ry, _mul32_lo(perm_seed, 0x02E5BE93), active)
        jx, jy, state = self._jitter_2d(state, active)
        fx = (x.to(torch.float32)
              + (sy.to(torch.float32) + jx) / ry) / rx
        fy = (y.to(torch.float32)
              + (sx.to(torch.float32) + jy) / rx) / ry
        return (fx, fy), state


# Sobol' second-dimension direction numbers: v[0] = 2^31,
# v[k+1] = v[k] ^ (v[k] >> 1); with the van der Corput first dimension
# this is the (0,2)-sequence in base 2
_SOBOL2_DIRS = []
_v = 1 << 31
for _ in range(32):
    _SOBOL2_DIRS.append(_v)
    _v ^= _v >> 1
_SOBOL2_DIRS = tuple(_SOBOL2_DIRS)
_INV_2_32 = 2.3283064365386963e-10


def _u32_to_unit(v):
    """A uint32 word (int64 tensor) times 2^-32 in float32: the int64 to
    float32 conversion rounds once, as a uint32 conversion does."""
    return v.to(torch.float32) * _INV_2_32


@register_plugin("sampler", "ldsampler")
class LDSampler(Sampler):
    """Low-discrepancy sampler (reference src/samplers/ldsampler.cpp):
    each 2D draw is a scrambled (0,2)-sequence pair (van der Corput and
    Sobol'), 1D draws the scrambled van der Corput sequence. It draws
    nothing from the PCG32 streams."""

    @staticmethod
    def _vdc(idx, scramble):
        v = idx
        # bit-reverse a 32-bit word
        v = ((v >> 16) | (v << 16)) & MASK32
        v = (((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)) & MASK32
        v = (((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)) & MASK32
        v = (((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)) & MASK32
        v = (((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)) & MASK32
        return _u32_to_unit(v ^ scramble)

    @staticmethod
    def _sobol2(idx, scramble):
        v = scramble
        for bit, d in enumerate(_SOBOL2_DIRS):
            v = torch.where(((idx >> bit) & 1) != 0, v ^ d, v)
        return _u32_to_unit(v)

    def next_1d(self, state, active=None):
        idx = self.current_sample_index(state)
        scramble = (state.permutation_seed
                    + ((state.dimension_index * 0x9E3779B9) & MASK32)) \
            & MASK32
        state = state._replace(dimension_index=state.dimension_index + 1)
        return self._vdc(idx, scramble), state

    def next_2d(self, state, active=None):
        idx = self.current_sample_index(state)
        dim = state.dimension_index
        s1 = (state.permutation_seed + ((dim * 0x9E3779B9) & MASK32)) \
            & MASK32
        s2 = (state.permutation_seed
              + ((dim * 0x8D2FBC71 + 0x4B1BD1B5) & MASK32)) & MASK32
        state = state._replace(dimension_index=dim + 1)
        return (self._vdc(idx, s1), self._sobol2(idx, s2)), state


_ORTHO_STRATUM = 0x51633E2D
_ORTHO_SUB = 0x68BC21EB


@register_plugin("sampler", "orthogonal")
class OrthogonalSampler(_JitteredStrata):
    """Orthogonal-array sampler (reference src/samplers/orthogonal.cpp):
    Bose's construction for strength 2 (orthogonal.cpp:215-243), Bush's
    above it (:194-212), both with the correlated multi-jitter
    randomization. The grid resolution is the smallest prime whose square
    covers the requested spp (:94-108)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.strength = props.get_int("strength", 2)
        self._update_resolution()

    @staticmethod
    def _is_prime(x):
        if x < 2:
            return False
        k = 2
        while k * k <= x:
            if x % k == 0:
                return False
            k += 1
        return True

    def _update_resolution(self):
        r = 2
        while r * r < self.sample_count or not self._is_prime(r):
            r += 1
        self.resolution = r
        self.sample_count = r * r

    def set_sample_count(self, spp: int):
        self.sample_count = spp
        self._update_resolution()

    def _seeds(self, p, j):
        """The stratum and sub-stratum permutation seeds of dimension j:
        p * (j + 1) * constant, mod 2^32."""
        return (_mul32_lo(p, ((j + 1) * _ORTHO_STRATUM) & MASK32),
                _mul32_lo(p, ((j + 1) * _ORTHO_SUB) & MASK32))

    def next_1d(self, state, active=None):
        i = self.current_sample_index(state)
        p = state.permutation_seed
        j = state.dimension_index & MASK32
        state = state._replace(dimension_index=state.dimension_index + 1)
        if self.strength != 2:
            return self._bush(state, i, j, p, active)
        # Bose construction (strength 2)
        res = self.resolution
        i = permute_kensler(i % self.sample_count, self.sample_count, p,
                            active)
        a_i0 = i // res
        a_i1 = i - a_i0 * res
        if j == 0:
            a_ij, a_ik = a_i0, a_i1
        elif j == 1:
            a_ij, a_ik = a_i1, a_i0
        else:
            k = j - 1 if j % 2 > 0 else j + 1
            a_ij = ((a_i0 + _mul32_lo(a_i1, (j - 1) & MASK32)) & MASK32) \
                % res
            a_ik = ((a_i0 + _mul32_lo(a_i1, (k - 1) & MASK32)) & MASK32) \
                % res
        seed_s, seed_sub = self._seeds(p, j)
        stratum = permute_kensler(a_ij, res, seed_s, active)
        sub = permute_kensler(a_ik, res, seed_sub, active)
        jit, state = self._jitter(state, active)
        v = (stratum.to(torch.float32)
             + (sub.to(torch.float32) + jit) / res) / res
        return v, state

    def _bush(self, state, i, j, p, active):
        res = self.resolution
        n = res ** self.strength
        stm = n // res
        i = permute_kensler(i % n, n, p, active)
        # the digits of i in base res, as a polynomial evaluated at x = j
        digits = []
        tmp = i
        for _ in range(self.strength):
            digits.append(tmp % res)
            tmp = tmp // res
        phi = torch.zeros_like(i)
        for dgt in reversed(digits):
            phi = (_mul32_lo(phi, j) + dgt) & MASK32
        seed_s, seed_sub = self._seeds(p, j)
        stratum = permute_kensler(phi % res, res, seed_s, active)
        sub = permute_kensler((i // res) % stm, stm, seed_sub, active)
        jit, state = self._jitter(state, active)
        v = (stratum.to(torch.float32)
             + (sub.to(torch.float32) + jit) / stm) / res
        return v, state

    def next_2d(self, state, active=None):
        f1, state = self.next_1d(state, active)
        f2, state = self.next_1d(state, active)
        return (f1, f2), state


__all__ = [
    "Sampler", "SamplerState", "IndependentSampler", "CorrelatedSampler",
    "TimeStratifiedSampler", "StratifiedSampler", "MultijitterSampler",
    "LDSampler", "OrthogonalSampler",
    "TIME_UNIFORM", "TIME_STRATIFIED", "TIME_ANTITHETIC",
    "TIME_ANTITHETIC_MIRROR", "TIME_PERIODIC", "TIME_SAMPLING_METHODS",
]
