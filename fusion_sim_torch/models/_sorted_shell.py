"""The life cycle of the tile-sorted layout, shared by the sorted shells.

``SortedElectrostaticPIC`` and ``SortedElectromagneticPIC`` inherit
``SortedShell`` and keep only their own options and kernel step; the
pusher's sorted path (models/pusher.py) calls this module's functions.
What every sorted shell decides lives here once:

* the check of the spill patch, tier, repair and precision options;
* the repair state: each tile's dead-slot stack and the unplaced count;
* the resort, and the reference's resort cadence around the step, which
  ends with the drain check when repair is on;
* the spill account: the ``spill`` / ``spill_dropped`` counters, the
  ``rows_patched`` counter and the warning.

The rows a step patches come from ``ops/interp.patch_rows``.
"""

from __future__ import annotations

import inspect
import math
import warnings

import numpy as np
import torch

from .._device import resolve_device
from ..ops.precision import PRECISIONS, resolve_precision
from ..ops.repair import drain_check, init_free_list, repair_relocate
from ..ops.sorted_deposit import Tiling2D, Tiling3D, build_padded_layout
from ..utils.profiling import count, span


def check_tiers(spill_tiers, spill_capacity: int) -> tuple[int, ...]:
    """``spill_tiers`` as a tuple: strictly ascending patch capacities
    below ``spill_capacity``.  A step compacts its patch rows at the
    smallest one that covers its spill count; a buffer size only, as the
    same rows are patched either way."""
    ts = tuple(int(t) for t in spill_tiers or ())
    if list(ts) != sorted(set(ts)) or any(t <= 0 for t in ts) \
            or (ts and ts[-1] >= spill_capacity):
        raise ValueError(
            f"spill_tiers {spill_tiers!r} must be strictly ascending "
            f"positives below spill_capacity {spill_capacity}")
    return ts


def with_free_list(state, n_tiles: int, block: int, free_slots: int):
    """``state`` with each tile's dead-slot stack of its fresh layout."""
    fidx, fcnt = init_free_list(state.tile_id, state.valid, n_tiles, block,
                                free_slots)
    return state._replace(free_idx=fidx, free_cnt=fcnt)


def with_repair_state(state, n_tiles: int, block: int, free_slots: int):
    """``state`` with the unplaced count and the dead-slot stacks, where
    it has none."""
    if state.unplaced is None:
        state = state._replace(unplaced=torch.zeros(
            (), dtype=torch.int64, device=state.valid.device))
    if state.free_idx is None:
        state = with_free_list(state, n_tiles, block, free_slots)
    return state


def run_cadence(n: int, since: int, need_resort: bool, unplaced_seen: int,
                *, resort_every: int, repair: bool, step_once, resort,
                state, buffer: int, n_real: int, whole_window: float = 128):
    """Advance ``n`` steps with the reference's resort cadence and return
    the counters ``(since, need_resort, unplaced_seen)`` that follow.

    ``since`` counts the steps since the last resort.  Without repair, a
    run that starts on a fresh sort and spans a whole window of
    ``resort_every`` steps (up to ``whole_window``) runs them and THEN
    resorts, and the counter stays 0; partial chunks count toward the next
    window, whose resort runs at the start of a later call.  With repair
    the resort runs at the start of a window or after the free stacks
    drained, and the call ends with the drain check (one host read of
    ``state()``'s unplaced count), sized by ``buffer``, the rows a step can
    relocate.  ``step_once()`` and ``resort()`` act on the shell."""
    done = 0
    while done < n:
        if since >= resort_every or need_resort:
            resort()
            since, need_resort = 0, False
        if (not repair and since == 0 and n - done >= resort_every
                and resort_every <= whole_window):
            for _ in range(resort_every):
                step_once()
            resort()
            done += resort_every
            continue
        k = min(n - done, resort_every - since)
        for _ in range(k):
            step_once()
        since += k
        done += k
    if repair:
        # a small unplaced trickle is normal (a row whose target tile is
        # full keeps its exact patch and retries); a large delta means the
        # stacks drained: resort at the next call
        need_resort, unplaced_seen, _ = drain_check(
            state(), unplaced_seen, 0, buffer, n_real, n)
    return since, need_resort, unplaced_seen


class SortedShell:
    """The base of the sorted ES and EM shells: the options, layout,
    resort cadence, repair state and spill account they share.

    A subclass sets, in its ``_configure`` (whose parameters are the
    constructor's but for the particle and field arrays), ``_cell_order``
    (whether the layout orders each tile's rows by cell) and
    ``_step_once``, and names its state's loader ``_state_from_numpy``."""

    # the largest resort_every whose whole window resorts at its end
    _whole_window = 128

    def _configure_layout(self, config, tiling, resort_every, check_spill,
                          spill_fallback, spill_capacity, spill_tiers,
                          repair, repair_free_slots, repair_eager,
                          eager_capacity, pallas_precision, device) -> None:
        """Check and keep the options every sorted shell takes; the
        defaults and messages are the reference's."""
        self.config = config
        self.spill_fallback = spill_fallback
        self.spill_capacity = int(spill_capacity)
        self.spill_tiers = check_tiers(spill_tiers, self.spill_capacity)
        if repair and self.spill_tiers:
            raise ValueError("spill_tiers is incompatible with repair=True "
                             "(the relocation chain is equilibrium-"
                             "capacity-sized every step)")
        if repair and not spill_fallback:
            raise ValueError("repair=True requires spill_fallback=True")
        self.repair = repair
        self.repair_free_slots = int(repair_free_slots)
        # repair_eager=k: also relocate rows within k cells of leaving
        # their window, carrying their own exact values (ops/repair.py)
        self.repair_eager = int(repair_eager)
        self.eager_capacity = (int(spill_capacity) if eager_capacity is None
                               else int(eager_capacity))
        if self.repair_eager and self.eager_capacity <= 0:
            raise ValueError(f"eager_capacity={eager_capacity} must be > 0")
        if pallas_precision is not None and pallas_precision not in PRECISIONS:
            raise ValueError(f"pallas_precision {pallas_precision!r}")
        if pallas_precision == "exact_bf16_pack2" and config.n_dim != 2:
            raise ValueError("exact_bf16_pack2 is 2D-only")
        self.pallas_precision = pallas_precision
        self.tiling = tiling or (Tiling2D() if config.n_dim == 2
                                 else Tiling3D())
        if self.repair_eager:
            if not repair:
                raise ValueError("repair_eager requires repair=True")
            if not 0 < self.repair_eager <= self.tiling.margin:
                raise ValueError(
                    f"repair_eager={self.repair_eager} must be in "
                    f"1..margin ({self.tiling.margin})")
        resolve_precision(pallas_precision, self.tiling.dtype)
        self.resort_every = resort_every
        self.check_spill = check_spill
        self.device = resolve_device(device)
        self._n_tiles = math.prod(self.tiling.n_tiles(config.grid_shape))
        self._since_sort = 0
        self._need_resort = False
        self._spill_seen = self._dropped_seen = self._unplaced_seen = 0

    @classmethod
    def from_state(cls, config, blob: dict, tiling=None, **kwargs):
        """A model on a given sorted state (the form of the shell's
        ``*_state_from_numpy``): no initial sort, so it starts from exactly
        that layout.  Keyword arguments as the constructor's."""
        self = cls.__new__(cls)
        bound = inspect.signature(cls.__init__).bind(
            self, config, None, None, tiling=tiling, **kwargs)
        bound.apply_defaults()
        own = inspect.signature(cls._configure).parameters
        self._configure(**{k: v for k, v in bound.arguments.items()
                           if k in own and k != "self"})
        self.state = cls._state_from_numpy(blob, self.device)
        self.n_real = int(self.state.valid.sum())
        self._finish_state()
        return self

    def _layout(self, position, velocity, valid=None):
        """``build_padded_layout`` with this shell's layout options."""
        return build_padded_layout(
            position, self.config.grid_shape, self.tiling, velocity,
            valid=valid, reserve=self.repair, spread=self.repair,
            derive_valid=True, cell_order=self._cell_order)

    def _initial_layout(self, position, velocity, width: int) -> dict:
        """The fields of a fresh sorted state from host arrays (``width``
        velocity components a row)."""
        n = np.asarray(position).shape[0]
        if n % self.tiling.block:
            raise ValueError(f"particle count must be a multiple of "
                             f"{self.tiling.block}")
        self.n_real = n
        pos = torch.as_tensor(
            np.asarray(position, np.float32).reshape(n, self.config.n_dim),
            device=self.device)
        vel = torch.as_tensor(
            np.asarray(velocity, np.float32).reshape(n, width),
            device=self.device)
        tid, pos_p, vel_p, valid_p, _ = self._layout(pos, vel)
        return dict(position=pos_p, velocity=vel_p, tile_id=tid,
                    valid=valid_p, step=0, spill=0, spill_dropped=0)

    def _finish_state(self) -> None:
        """The repair stacks and counter, where repair is on and missing."""
        if self.repair:
            self.state = with_repair_state(self.state, self._n_tiles,
                                           self.tiling.block,
                                           self.repair_free_slots)

    def _rebuild_free_list(self) -> None:
        self.state = with_free_list(self.state, self._n_tiles,
                                    self.tiling.block, self.repair_free_slots)

    def _resort(self) -> None:
        """Rebuild the layout (one sort); fillers and invalid rows sink to
        the trailing dead region, which the truncation drops (the real
        count is conserved: periodic, no sinks)."""
        with span("resort"):
            s = self.state
            n_state = s.position.shape[0]
            tid, pos_p, vel_p, valid_p, _ = self._layout(
                s.position, s.velocity, s.valid)
            self.state = s._replace(
                position=pos_p[:n_state], velocity=vel_p[:n_state],
                tile_id=tid[:n_state], valid=valid_p[:n_state])
            if self.repair:
                self._rebuild_free_list()

    def _capacities(self) -> tuple[int, ...]:
        """``patch_rows``' capacities: the tiers, then ``spill_capacity``;
        with the fallback off, one of 0, which counts and patches none."""
        if not self.spill_fallback:
            return (0,)
        return (*self.spill_tiers, self.spill_capacity)

    def _relocated(self, state, x1, velocity, idx, x1_k, vel_k, in_win):
        """With repair on: the patched rows ``idx`` (values ``x1_k``/
        ``vel_k``) and, with ``repair_eager``, the band rows moved into
        their new tile (``ops/repair.repair_relocate``); returns ``(x1,
        velocity, state updates)``."""
        if not self.repair:
            return x1, velocity, {}
        with span("repair"):
            x1, velocity, _, extra = repair_relocate(
                state, x1, velocity, idx if idx.numel() else None, None,
                x1_k, vel_k, self.config.grid_shape, self.tiling,
                self._n_tiles, self.config.n_dim, in_win=in_win,
                eager_keep=self.repair_eager, eager_cap=self.eager_capacity)
        return x1, velocity, extra

    def _advanced(self, state, spill: int) -> dict:
        """The step's counter updates: ``step``, ``spill`` and
        ``spill_dropped`` (the rows past ``spill_capacity``; every spilled
        row with the fallback off); counts ``rows_patched``."""
        dropped = (max(spill - self.spill_capacity, 0) if self.spill_fallback
                   else spill)
        count("rows_patched", spill - dropped)
        return dict(step=state.step + 1, spill=state.spill + spill,
                    spill_dropped=state.spill_dropped + dropped)

    def _check_spill(self) -> None:
        # report the delta since the previous check, not the cumulative
        # counter (one spill event must not re-warn forever)
        spilled = self.state.spill - self._spill_seen
        self._spill_seen += spilled
        dropped = self.state.spill_dropped - self._dropped_seen
        self._dropped_seen += dropped
        if spilled or dropped:
            if not self.spill_fallback:
                msg = (f"{spilled} spilled rows are APPROXIMATE "
                       f"(spill_fallback=False: deposits dropped, fields "
                       f"gathered from the clamped window; charge not "
                       f"conserved)")
            elif dropped:
                msg = (f"{dropped} spilled rows exceeded spill_capacity="
                       f"{self.spill_capacity} and were NOT patched (their "
                       f"deposits are lost; raise spill_capacity)")
            else:
                msg = (f"{spilled} particle-deposits took the slow exact "
                       f"fallback (out-drifted the sort margin)")
            warnings.warn(
                msg + f"; reduce resort_every (now {self.resort_every}) or "
                f"raise tiling.margin (now {self.tiling.margin})",
                RuntimeWarning, stacklevel=3)

    def step(self, n: int = 1) -> None:
        """Advance ``n`` steps with the reference's resort cadence
        (``run_cadence``; with repair a call ends with the drain check,
        one host read), then warn of the spill since the last call."""
        with span("step"):
            buffer = max(self.spill_capacity,
                         self.eager_capacity if self.repair_eager else 0)
            self._since_sort, self._need_resort, self._unplaced_seen = \
                run_cadence(n, self._since_sort, self._need_resort,
                            self._unplaced_seen,
                            resort_every=self.resort_every,
                            repair=self.repair, step_once=self._step_once,
                            resort=self._resort, state=lambda: self.state,
                            buffer=buffer, n_real=self.n_real,
                            whole_window=self._whole_window)
            if self.check_spill:
                self._check_spill()
