"""Append-only per-replica lifecycle journal + pure replay oracle.

Every replica (``EngineConfig.journal=True``) records each request state
transition, KV page acquisition/release, encoder-cache pin/unpin, and
fleet handoff (export / migration) as an immutable tuple. ``replay``
folds the log into terminal states and resource accounting **without
consulting any live engine state** — a second, independent derivation of
what the engine's allocator and pin table must now contain. The fleet
cross-checks the two bit-exactly at every kill, drain completion, and
end of run (``verify_engine``): a divergence means either a resource
release was missed/doubled on the live path or a record was dropped on
the journal path — both are real bugs, so this is a runtime correctness
checker, not a debug aid.

Recovery uses the same log: when a replica crashes, ``replay(...).
inflight`` is the exact set of requests whose fate the dead replica
still owed — known stage at crash, so the fleet re-dispatches them for
residual re-prefill while everything already terminal (or already
exported to another replica) is excluded and can never double-finish.

Recording is pure observation: hooks are gated on ``journal is not
None``, touch no RNG and no clock, and allocate nothing the engine
reads back — a journal-enabled run is bit-identical to the same run
without it (benchmarks/recovery.py gates this against the pre-journal
``Fleet`` == ``Router`` baseline).

Record schema (see DESIGN.md §Recovery & lifecycle journal)::

    (seq, now, kind, rid, data)

    kind        data                     meaning
    ---------   ----------------------   --------------------------------
    state       stage name (str)         entered WAITING/ENCODING/
                                         PREFILLING/RUNNING/PREEMPTED
    terminal    terminal state (str)     entered FINISHED/REJECTED/
                                         FAILED/CANCELLED
    acquire     tuple of page ids        pages appended to the rid's
                                         block table (claim + fresh)
    release     None                     the rid's whole page list freed
    pin         mm_hash (str)            encoder-cache entry pinned
    unpin       mm_hash (str)            that pin released
    export      None                     non-terminal handoff off this
                                         replica (drain/migration/kill)
    migrate_in  page count (int)         page-chain import landed here
                                         (informational; pages enter the
                                         cache, not the rid's ownership)
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Journal:
    """The append-only log one engine writes. ``record`` is the only
    mutation; everything else reads ``records`` as immutable history."""
    records: list[tuple] = field(default_factory=list)

    def record(self, now: float, kind: str, rid: str,
               data=None) -> None:
        self.records.append((len(self.records), now, kind, rid, data))

    def __len__(self) -> int:
        return len(self.records)


@dataclass
class ReplayState:
    """What a pure left-fold of the journal says the engine must hold."""
    terminal: dict[str, str] = field(default_factory=dict)
    owned: dict[str, list[int]] = field(default_factory=dict)
    pins: dict[str, str] = field(default_factory=dict)
    stage: dict[str, str] = field(default_factory=dict)
    exported: set[str] = field(default_factory=set)

    @property
    def inflight(self) -> set[str]:
        """Requests this replica still owes a fate: ingested here, not
        terminal, and not handed off to another replica."""
        return {rid for rid in self.stage
                if rid not in self.terminal and rid not in self.exported}


def replay(records) -> ReplayState:
    """Pure fold of journal records into reconstructed accounting.

    Ordering invariants the engine's hooks guarantee (and this relies
    on): ``release`` precedes the ``terminal``/``export`` record of the
    same transition; a re-ingested rid (exported away, later migrated
    back) opens with a fresh ``state`` record, which clears its exported
    mark — the replica owes it a fate again.
    """
    st = ReplayState()
    for _seq, _now, kind, rid, data in records:
        if kind == "state":
            st.stage[rid] = data
            st.exported.discard(rid)
        elif kind == "terminal":
            st.terminal[rid] = data
        elif kind == "acquire":
            st.owned.setdefault(rid, []).extend(data)
        elif kind == "release":
            st.owned.pop(rid, None)
        elif kind == "pin":
            st.pins[rid] = data
        elif kind == "unpin":
            st.pins.pop(rid, None)
        elif kind == "export":
            st.exported.add(rid)
        # migrate_in (and any future informational kind): no-op
    return st


def verify_engine(engine) -> list[str]:
    """Cross-check the replayed accounting against the live engine
    bit-exactly. Returns human-readable mismatch strings (empty = the
    two independent derivations agree). Compares:

      * terminal partition: replayed terminal map vs the engine's
        finished/rejected/aborted lists (same rids, same states);
      * page ownership: replayed block tables vs the allocator's
        ``owned_map()`` — same rids, same pages, same order;
      * encoder pins: replayed pin table vs ``engine._enc_pins``.
    """
    if engine.journal is None:
        return []
    st = replay(engine.journal.records)
    out: list[str] = []
    live_terminal = {r.rid: r.state.value
                     for r in (engine.finished + engine.rejected
                               + engine.aborted)}
    if st.terminal != live_terminal:
        only_live = {k: v for k, v in live_terminal.items()
                     if st.terminal.get(k) != v}
        only_replay = {k: v for k, v in st.terminal.items()
                       if live_terminal.get(k) != v}
        out.append(f"terminal mismatch: live-only {only_live!r} "
                   f"replay-only {only_replay!r}")
    live_owned = engine.allocator.owned_map()
    replay_owned = {rid: tuple(ps) for rid, ps in st.owned.items() if ps}
    if replay_owned != live_owned:
        only_live = {k: v for k, v in live_owned.items()
                     if replay_owned.get(k) != v}
        only_replay = {k: v for k, v in replay_owned.items()
                       if live_owned.get(k) != v}
        out.append(f"owned-pages mismatch: live-only {only_live!r} "
                   f"replay-only {only_replay!r}")
    live_pins = dict(engine._enc_pins)
    if st.pins != live_pins:
        out.append(f"encoder-pin mismatch: live {live_pins!r} "
                   f"replay {st.pins!r}")
    return out
