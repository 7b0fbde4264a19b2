"""Local-search refinement of a schedule (beyond-paper enhancement).

Port of ``repro.core.refine``'s state engine. The paper's Algorithm 2 only
ever *adds* instances; this pass rebalances with a hill climb over these
move types, each scored by the closed-form maximum stable throughput:

* RELOCATE — move one instance to a different machine;
* SWAP     — exchange the machines of two instances of different components;
* ADD      — grow one component by one instance on some machine;
* GROW     — grow one component by k instances at once, placed greedily;
* PAIRGROW — grow two components together (crosses eq. 6 re-split valleys);
* DROP     — remove an instance of a component with >= 2 instances.

The climb applies the single best improving move until no move improves
throughput by more than ``tol``. Moves are O(m) ``ScheduleState`` deltas;
each round's candidates are exported as (B, T) task->machine rows and
scored in batched sweeps on ``device`` (one RELOCATE+SWAP sweep per row
chunk, four depth-lockstep growth sweeps, one DROP sweep). The scorer gives
the reference NumPy floats bit for bit on either device, and winners are
strict-``>`` first maxima in the reference enumeration order, so the port
applies the same move sequence as ``repro``'s engines.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import max_stable_rate
from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.profiles import Cluster
from repro_torch.core.schedule_state import ScheduleState

__all__ = ["RefineResult", "refine"]

# Candidate rows scored per vectorized sweep; bounds the (chunk, T) batch
# memory on large clusters without changing results (rows are independent).
# Network-aware clusters tighten this further (see ``_effective_chunk``):
# the cut-traffic term expands every row into (n_components, m) scatter
# tensors plus distance matvecs, so the naive cap would materialize the
# full edge×machine product on wide topologies (regression-tested at m=90).
_SCORE_CHUNK = 16_384


def _effective_chunk(cluster: Cluster, n_components: int) -> int:
    """Rows per scoring sweep: ``_SCORE_CHUNK``, tightened on network-aware
    clusters so one sweep's distance-expanded accumulation stays within the
    ``cost_model._NET_CHUNK_ELEMS`` (chunk · n · m) element budget instead
    of relying on the inner chunking to re-split an oversized batch."""
    if not cluster.has_network:
        return _SCORE_CHUNK
    per_row = max(1, n_components * cluster.n_machines)
    return min(_SCORE_CHUNK, max(256, cost_model._NET_CHUNK_ELEMS // per_row))

# Total steps (prefix included) a depth-adaptive growth chain may reach —
# a runaway backstop far above any profitable chain (the reference's value,
# so adaptive stopping decisions match it).
_ADAPTIVE_GROW_CAP = 64


@dataclasses.dataclass(frozen=True)
class RefineResult:
    etg: ExecutionGraph
    rate: float
    throughput: float
    moves: list[str]


def _score(etg: ExecutionGraph, cluster: Cluster) -> float:
    return max_stable_rate(etg, cluster)[1]


def refine(
    etg: ExecutionGraph,
    cluster: Cluster,
    max_rounds: int = 200,
    tol: float = 1e-9,
    allow_add: bool = True,
    adaptive_growth: bool = False,
    skew: "cost_model.SkewModel | None" = None,
    device: str | torch.device = "cuda",
    recorder=None,
) -> RefineResult:
    """Hill-climb refinement of ``etg``'s placement (and instance counts).

    Args:
      etg: schedule to refine (not mutated).
      cluster: the heterogeneous cluster.
      max_rounds: maximum number of applied moves.
      tol: minimum throughput improvement for a move to be applied.
      allow_add: when False, only count-preserving moves (RELOCATE/SWAP)
        are considered.
      adaptive_growth: keep extending growth chains past the reference
        menu's depth 4 while their closed-form score strictly improves,
        offering GROW k>4 and PAIRGROW (a, b>2) candidates.
      skew: optional ``cost_model.SkewModel`` — every candidate (and the
        incumbent) scores with the skew-aware per-instance utilization
        bound instead of the eq. 6 even split.
      device: where candidate sweeps are scored — ``"cuda"`` (default: the
        hand-written kernel; raises without a card) or ``"cpu"`` (the plain
        PyTorch version). Both give identical results.
      recorder: optional ``repro_torch.obs.TraceRecorder``. When enabled,
        the climb runs under a ``refine`` span (its ``backend`` argument
        names the device) with one ``refine.round`` span per round, and
        the recorder is *activated* for the duration so every closed-form
        device resolution during scoring lands in its dispatch log.
        ``None`` (or a ``NullRecorder``) adds no work to the climb.
    """
    rec = recorder if recorder is not None and recorder.enabled else None
    if rec is None:
        return _refine_state(
            etg, cluster, max_rounds, tol, allow_add, device, adaptive_growth, skew
        )
    with rec.activate(), rec.span(
        "refine", cat="refine", engine="state", backend=str(device)
    ) as sp:
        result = _refine_state(
            etg, cluster, max_rounds, tol, allow_add, device, adaptive_growth, skew,
            recorder=rec,
        )
        sp["args"]["applied_moves"] = len(result.moves)
        sp["args"]["throughput"] = float(result.throughput)
    return result


# ------------------------------------------------------------ state engine


class _GrowChain:
    """One greedy growth chain: its current exported row, block offsets and
    instance-count vector, plus the placements/scores of every step so far.

    After j steps, ``scores[j - 1]`` is the closed-form throughput of the
    j-step prefix and ``placements[:j]`` is the move that realizes it —
    uniform across single-component chains (ADD/GROW) and pair chains
    (PAIRGROW), which fork from a single chain's prefix.
    """

    __slots__ = ("row", "offsets", "n_inst", "placements", "scores")

    def __init__(self, row: np.ndarray, offsets: np.ndarray, n_inst: np.ndarray):
        self.row = row
        self.offsets = offsets
        self.n_inst = n_inst
        self.placements: list[tuple[int, int]] = []
        self.scores: list[float] = []

    def fork(self) -> "_GrowChain":
        # Steps rebind row/offsets and copy-on-write n_inst, so forking a
        # prefix shares the arrays and copies only the Python lists.
        child = _GrowChain(self.row, self.offsets, self.n_inst.copy())
        child.placements = list(self.placements)
        child.scores = list(self.scores)
        return child


def _lockstep_extend(
    state: ScheduleState,
    chains: list[_GrowChain],
    comps: list[int],
    device,
) -> None:
    """One lockstep depth: score every live chain's next greedy step in a
    single per-row-count sweep and apply each chain's winner.

    Chain i appends one instance of ``comps[i]``; its m candidate rows are
    column inserts on its own row, and the whole depth scores as one
    ``score_task_machine_batch`` call with a (B, n) count matrix (B =
    len(chains) * m). Rows are scored independently and each chain's winner
    is the strict first-max over its own contiguous m rows in machine
    order, so scores and winners are bit-identical to scoring each chain's
    m rows alone.
    """
    if not chains:
        return
    m = state.cluster.n_machines
    T = int(chains[0].row.shape[0])
    k = len(chains)
    comps_arr = np.asarray(comps, dtype=np.int64)
    base = np.stack([ch.row for ch in chains])           # (k, T)
    pos = np.array(
        [int(ch.offsets[c + 1]) for ch, c in zip(chains, comps)],
        dtype=np.int64,
    )  # append at end of each chain's grown block
    counts = np.stack([ch.n_inst for ch in chains])      # (k, n)
    counts[np.arange(k), comps_arr] += 1
    # Insert one column at pos[i]: source column j-1 right of the insert, j
    # left of it; the insert column itself is overwritten with the machine
    # index, so its clipped source value is irrelevant.
    cols = np.arange(T + 1)
    src = np.clip(cols[None, :] - (cols[None, :] > pos[:, None]), 0, max(T - 1, 0))
    tm = np.repeat(np.take_along_axis(base, src, axis=1), m, axis=0)
    tm[np.arange(k * m), np.repeat(pos, m)] = np.tile(np.arange(m), k)
    n_rows = np.repeat(counts, m, axis=0)
    _, scores = state.score_task_machine_batch(tm, n_rows, device=device)
    winners = scores.reshape(k, m).argmax(axis=1)
    for i, (ch, c) in enumerate(zip(chains, comps)):
        w = int(winners[i])
        ch.row = tm[i * m + w]
        new_off = ch.offsets.copy()
        new_off[c + 1 :] += 1
        ch.offsets = new_off
        ch.n_inst[c] += 1
        ch.placements.append((c, w))
        ch.scores.append(float(scores[i * m + w]))


def _adaptive_live(chains: list[tuple[_GrowChain, int]]) -> list[tuple[_GrowChain, int]]:
    """Chains that keep extending: last step strictly improved, cap not hit.

    The stopping rule both explorers share — a chain whose deepest step did
    not strictly beat the one before it has crossed its eq. 6 re-split
    valley floor and stops.
    """
    return [
        (ch, c)
        for ch, c in chains
        if len(ch.scores) < _ADAPTIVE_GROW_CAP and ch.scores[-1] > ch.scores[-2]
    ]


def _adaptive_extend_lockstep(
    state: ScheduleState,
    singles: list[_GrowChain],
    pair_a: dict,
    pair_b: dict,
    pairs: list[tuple[int, int]],
    device,
) -> None:
    """Depth-adaptive continuation: extend every still-improving chain one
    step per sweep until none improves.

    Chains at different depths carry different task totals, so each
    iteration groups live chains by row length and runs one per-row-count
    sweep per group — still O(depth) sweeps per round, independent of
    component count.
    """
    live = [(singles[c], c) for c in range(len(singles))]
    live += [(pair_a[p], p[1]) for p in pairs]
    live += [(pair_b[p], p[1]) for p in pairs]
    while True:
        live = _adaptive_live(live)
        if not live:
            return
        groups: dict[int, list[tuple[_GrowChain, int]]] = {}
        for ch, c in live:
            groups.setdefault(int(ch.row.shape[0]), []).append((ch, c))
        for length in sorted(groups):
            _lockstep_extend(
                state,
                [ch for ch, _ in groups[length]],
                [c for _, c in groups[length]],
                device,
            )


def _growth_chains_lockstep(
    state: ScheduleState,
    base_tm: np.ndarray,
    offsets: np.ndarray,
    n_inst: np.ndarray,
    device,
    adaptive: bool = False,
) -> tuple[list[_GrowChain], dict, dict, list[tuple[int, int]]]:
    """Explore every greedy growth chain in four depth-lockstep sweeps.

    Single chains (one per component, 4 steps each: ADD + GROW k=2/3/4) and
    pair chains (PAIRGROW (a, b) forks off the single chain's a-step
    prefix, then adds cj) advance together: every chain at depth d has the
    same task total T + d, so one rectangular per-row-count sweep scores
    all of them. A refine round's growth exploration is 4 sweeps total,
    independent of component count (versus ~4n + 4·C(n,2) m-row sweeps
    stepping the chains one at a time).
    """
    n = state.utg.n_components
    pairs = [(ci, cj) for ci in range(n) for cj in range(ci + 1, n)]
    singles = [_GrowChain(base_tm, offsets, n_inst.copy()) for _ in range(n)]
    # Depth 1: each single chain's first step (the ADD candidate).
    _lockstep_extend(state, singles, list(range(n)), device)
    # PAIRGROW (1, b) forks off the 1-step prefix before depth 2 extends it.
    pair_a = {p: singles[p[0]].fork() for p in pairs}
    # Depth 2: singles (GROW k=2) + first cj of every (1, b) pair chain.
    _lockstep_extend(
        state,
        singles + [pair_a[p] for p in pairs],
        list(range(n)) + [cj for _, cj in pairs],
        device,
    )
    # PAIRGROW (2, b) forks off the 2-step prefix before depth 3.
    pair_b = {p: singles[p[0]].fork() for p in pairs}
    # Depth 3: singles (GROW k=3), second cj of (1, b), first cj of (2, b).
    _lockstep_extend(
        state,
        singles + [pair_a[p] for p in pairs] + [pair_b[p] for p in pairs],
        list(range(n)) + [cj for _, cj in pairs] * 2,
        device,
    )
    # Depth 4: singles (GROW k=4) + second cj of (2, b).
    _lockstep_extend(
        state,
        singles + [pair_b[p] for p in pairs],
        list(range(n)) + [cj for _, cj in pairs],
        device,
    )
    if adaptive:
        _adaptive_extend_lockstep(state, singles, pair_a, pair_b, pairs, device)
    return singles, pair_a, pair_b, pairs


def _refine_state(
    etg: ExecutionGraph,
    cluster: Cluster,
    max_rounds: int,
    tol: float,
    allow_add: bool,
    device,
    adaptive_growth: bool = False,
    skew=None,
    recorder=None,
) -> RefineResult:
    """Incremental-engine hill climb: identical decisions, batched scoring.

    Per round, every move family is expressed as edits on the flattened
    (T,) task->machine row exported from ``ScheduleState`` and scored in
    vectorized ``max_stable_rate_batch`` sweeps — one sweep covers all
    RELOCATE+SWAP candidates, four depth-lockstep per-row-count sweeps
    cover every growth chain (ADD/GROW/PAIRGROW), and one more covers all
    DROP candidates: ~6 sweeps per round. Candidate scores are
    bit-identical to the reference engine's scalar scoring (same
    ``max_stable_rate_batch`` row computation), and winners are selected
    with the same strict-``>`` first-max semantics in the same enumeration
    order, so both engines apply the same move sequence. Applying a move is
    an O(m) ``ScheduleState`` delta; growth exploration carries candidate
    rows/counts per chain, never mutating the live state.
    """
    state = ScheduleState.from_etg(etg, cluster, skew=skew)
    if skew is None:
        best = _score(state.to_etg(), cluster)
    else:
        # The incumbent must score under the same skew-aware bound as the
        # candidates, or offers get compared against the even-split score.
        best = float(
            state.score_task_machine_batch(
                state.task_machine()[None, :], device=device
            )[1][0]
        )
    moves: list[str] = []
    m = cluster.n_machines
    n = state.utg.n_components

    for round_idx in range(max_rounds):
        # Per-round profiling span (opened/closed manually so the
        # convergence `break` below can close it without reindenting the
        # whole round body under a `with`).
        round_span = sp = None
        if recorder is not None:
            round_span = recorder.span("refine.round", cat="refine", round=round_idx)
            sp = round_span.__enter__()
        best_move: tuple[float, str, "function"] | None = None

        def offer(score: float, desc: str, apply_fn) -> None:
            nonlocal best_move
            if score > best + tol and (best_move is None or score > best_move[0]):
                best_move = (score, desc, apply_fn)

        base_tm = state.task_machine()
        offsets = state.component_offsets()
        T = int(base_tm.shape[0])
        # Copy: growth exploration below mutates state.n_instances in place
        # before snapshot/restore swaps in a fresh array.
        n_inst = state.n_instances.copy()
        comp_of = np.repeat(np.arange(n), n_inst)

        # RELOCATE + SWAP share the template (counts unchanged): candidates
        # are 1-2 column edits on the base row, scored in one sweep. Within
        # the concatenated [relocate..., swap...] order, np.argmax is the
        # reference's first strictly-greater winner.
        W = np.tile(np.arange(m), (T, 1))
        keep = (W != base_tm[:, None]).ravel()
        reloc_pos = np.repeat(np.arange(T), m)[keep]
        reloc_w = W.ravel()[keep]
        a_idx, b_idx = np.triu_indices(T, 1)
        pair_ok = (comp_of[a_idx] != comp_of[b_idx]) & (
            base_tm[a_idx] != base_tm[b_idx]
        )
        swap_a, swap_b = a_idx[pair_ok], b_idx[pair_ok]
        b1, b2 = reloc_pos.size, swap_a.size
        # Each candidate = two column writes (a relocate writes one column
        # twice), so construction chunks alongside scoring.
        pos_a = np.concatenate([reloc_pos, swap_a])
        val_a = np.concatenate([reloc_w, base_tm[swap_b]])
        pos_b = np.concatenate([reloc_pos, swap_b])
        val_b = np.concatenate([reloc_w, base_tm[swap_a]])
        scores = np.empty(b1 + b2, dtype=np.float64)
        chunk = _effective_chunk(cluster, n)
        for start in range(0, b1 + b2, chunk):
            stop = min(start + chunk, b1 + b2)
            tm = np.tile(base_tm, (stop - start, 1))
            rows = np.arange(stop - start)
            tm[rows, pos_a[start:stop]] = val_a[start:stop]
            tm[rows, pos_b[start:stop]] = val_b[start:stop]
            scores[start:stop] = state.score_task_machine_batch(
                tm, n_inst, device=device
            )[1]
        if b1 + b2:
            i = int(np.argmax(scores))
            s = float(scores[i])
            if i < b1:
                p, w = int(reloc_pos[i]), int(reloc_w[i])
                c = int(comp_of[p])
                k, src = p - int(offsets[c]), int(base_tm[p])
                offer(
                    s,
                    f"relocate c{c}#{k} m{src}->m{w}",
                    lambda c=c, k=k, w=w: state.relocate_instance(c, k, w),
                )
            else:
                pa, pb = int(swap_a[i - b1]), int(swap_b[i - b1])
                ca, cb = int(comp_of[pa]), int(comp_of[pb])
                ka, kb = pa - int(offsets[ca]), pb - int(offsets[cb])
                offer(
                    s,
                    f"swap c{ca}#{ka}<->c{cb}#{kb}",
                    lambda ca=ca, ka=ka, cb=cb, kb=kb: state.swap_instances(
                        ca, ka, cb, kb
                    ),
                )

        if allow_add:
            def apply_adds(placements):
                for c, w in placements:
                    state.add_instance(c, w)

            # Greedy growth is deterministic, so the reference's independent
            # greedy_grow re-runs traverse shared prefixes: one 4-step chain
            # per component yields the ADD candidate (step 1) and the
            # GROW k=2/3/4 candidates (steps 2-4); PAIRGROW forks off the
            # first one or two steps of the first component's chain. The
            # lockstep explorer advances every chain together — 4
            # per-row-count sweeps per round regardless of component count.
            # Offers follow
            # the reference enumeration order (ADD..., GROW..., PAIRGROW...,
            # DROP...), which matters for exact-tie breaking under the
            # strict-> first-max rule.
            singles, pair_a, pair_b, pairs = _growth_chains_lockstep(
                state, base_tm, offsets, n_inst, device, adaptive_growth
            )
            # ADD: the reference's first-max over machines is exactly the
            # chain's first greedy step (same scores, same argmax).
            for c in range(n):
                ch = singles[c]
                offer(
                    ch.scores[0],
                    f"add c{c}->m{ch.placements[0][1]}",
                    lambda p=ch.placements[:1]: apply_adds(p),
                )
            # GROW: k instances of one component at once — the eq. 6
            # re-split means gains often appear only at specific counts,
            # invisible to single adds. Adaptive chains extend the menu
            # past k=4 for as deep as their scores kept improving.
            for c in range(n):
                ch = singles[c]
                for k in range(2, len(ch.scores) + 1):
                    offer(
                        ch.scores[k - 1],
                        f"grow c{c}x{k}",
                        lambda p=ch.placements[:k]: apply_adds(p),
                    )
            # PAIRGROW: components often need to grow *together* — the
            # eq. 6 re-split creates valleys between (x, y) and
            # (x+a, y+b) that per-component moves cannot cross. The (a, b)
            # combo is the (a + b)-step prefix of the (a, ·) pair chain.
            for ci, cj in pairs:
                pa, pb = pair_a[(ci, cj)], pair_b[(ci, cj)]
                for (a, b), ch in (
                    ((1, 1), pa),
                    ((2, 1), pb),
                    ((1, 2), pa),
                    ((2, 2), pb),
                ):
                    offer(
                        ch.scores[a + b - 1],
                        f"pairgrow c{ci}x{a}+c{cj}x{b}",
                        lambda p=ch.placements[: a + b]: apply_adds(p),
                    )
                # Adaptive extension of the pair menu: (a, b > 2) combos
                # for as deep as each pair chain kept improving.
                max_b = max(len(pa.scores) - 1, len(pb.scores) - 2)
                for b in range(3, max_b + 1):
                    for a, ch in ((1, pa), (2, pb)):
                        if len(ch.scores) - a >= b:
                            offer(
                                ch.scores[a + b - 1],
                                f"pairgrow c{ci}x{a}+c{cj}x{b}",
                                lambda p=ch.placements[: a + b]: apply_adds(p),
                            )
            # DROP: which instance to delete, over every component with
            # >= 2 instances — column removals on the base row, all scored
            # in one per-row-count sweep (winner still picked per component
            # to preserve the reference offer order).
            drop_rows: list[np.ndarray] = []
            drop_counts: list[np.ndarray] = []
            drop_span: list[tuple[int, int]] = []
            for c in range(n):
                nk = int(n_inst[c])
                if nk < 2:
                    continue
                cols = np.arange(T - 1)
                idx = cols[None, :] + (
                    cols[None, :] >= (int(offsets[c]) + np.arange(nk))[:, None]
                )
                n_new = n_inst.copy()
                n_new[c] -= 1
                drop_rows.append(base_tm[idx])
                drop_counts.append(np.tile(n_new, (nk, 1)))
                drop_span.append((c, nk))
            if drop_rows:
                _, sd_all = state.score_task_machine_batch(
                    np.concatenate(drop_rows, axis=0),
                    np.concatenate(drop_counts, axis=0),
                    device=device,
                )
                start = 0
                for c, nk in drop_span:
                    sd = sd_all[start : start + nk]
                    start += nk
                    k = int(np.argmax(sd))
                    offer(
                        float(sd[k]),
                        f"drop c{c}#{k}",
                        lambda c=c, k=k: state.drop_instance(c, k),
                    )

        if best_move is None:
            if round_span is not None:
                sp["args"]["move"] = None
                round_span.__exit__(None, None, None)
            break
        best, desc, apply_fn = best_move
        apply_fn()
        moves.append(desc)
        if round_span is not None:
            sp["args"]["move"] = desc
            sp["args"]["score"] = float(best)
            round_span.__exit__(None, None, None)

    final = state.to_etg()
    rate, thpt = max_stable_rate(final, cluster, skew=skew)
    return RefineResult(etg=final, rate=rate, throughput=thpt, moves=moves)
