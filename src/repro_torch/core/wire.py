"""Wire-format accounting — the single source of truth for payload bits.

Every "bits on the wire" number in the repo (compressor ``payload_bits``,
``FlatEngine.payload_bits``, the trainer's communication ledger, the
benchmark payload columns) must come from this module, so compressor
bookkeeping and the engine can never drift apart (DESIGN.md §4.6).

The packed quantization wire fixes the representation per family:

* seeded RandK    — uint32 seed + K float32 values (indices regenerate from
                    the seed server-side).
* PermK           — uint32 seed + (padded/n) float32 values (the partition IS
                    the index).
* block QSGD      — per-block f32 ℓ2 norm + one level per coordinate:
                    a signed 4-bit nibble when s ≤ 7 (two per byte, eight per
                    uint32 lane word), int8 when s ≤ 127. The dither never
                    rides the wire (the server only needs levels + norms).
* block natural   — per-block f32 scale (reference power of two) + int8
                    sign·(exponent-delta+1) code per coordinate.
* RandK ∘ QSGD    — uint32 seed + per-block f32 norm of the K sampled values
                    + K quantized levels (4-bit/int8 as above): the
                    bandwidth-optimal composition quantizes only what RandK
                    kept.

All values are bits per worker per compressed round; float so the ledgers
can accumulate without overflow at production scale.

The module also owns the **bytes-by-link-tier ledger**
(:class:`TierLedger`): the transport layer (`launch/transport.py`) books
every payload collective it stages — direction (up/down), link tier
(loopback / ici / dcn — `launch/topology.py` classifies), collective kind,
and the bits from the per-format helpers above — so "how many bits crossed
the slow link" is answered by the same module that defines what a bit is.
"""

from __future__ import annotations

import dataclasses

F32_BITS = 32.0
SEED_BITS = 32.0      # one uint32 murmur3 seed
NIBBLE_BITS = 4.0     # signed 4-bit level (two per byte / eight per uint32)
INT8_BITS = 8.0

#: largest s whose signed levels fit a 4-bit two's-complement nibble
NIBBLE_MAX_S = 7
#: largest s whose signed levels fit int8
INT8_MAX_S = 127


def qsgd_level_bits(s: int) -> float:
    """Bits per quantized level on the packed wire: sign folded into the
    level, 4-bit nibble for s ≤ 7, int8 for s ≤ 127."""
    assert 1 <= s <= INT8_MAX_S, f"s={s} does not fit the int8 wire"
    return NIBBLE_BITS if s <= NIBBLE_MAX_S else INT8_BITS


def dense_f32_bits(d: int) -> float:
    """The uncompressed wire: one f32 per coordinate (sync rounds, Identity)."""
    return F32_BITS * d


def seeded_randk_bits(nblk: int, kb: int) -> float:
    """Seeded-RandK flat wire: uint32 seed + K f32 values (DESIGN.md §4.2)."""
    return SEED_BITS + F32_BITS * nblk * kb


def permk_bits(padded: int, n: int) -> float:
    """PermK flat wire: uint32 seed + the worker's padded/n f32 shard
    (DESIGN.md §4.5)."""
    assert padded % n == 0, "worker count must divide the padded dimension"
    return SEED_BITS + F32_BITS * padded / n


def block_qsgd_bits(nblk: int, block: int, s: int) -> float:
    """Packed block-QSGD wire: per-block f32 norm + one level per coordinate."""
    return F32_BITS * nblk + qsgd_level_bits(s) * nblk * block


def block_natural_bits(nblk: int, block: int) -> float:
    """Packed natural-compression wire: per-block f32 scale + int8
    sign·(exponent-delta+1) code per coordinate."""
    return F32_BITS * nblk + INT8_BITS * nblk * block


def randk_qsgd_bits(nblk: int, kb: int, s: int) -> float:
    """RandK∘QSGD composition wire: uint32 seed (indices regenerate) +
    per-block f32 norm of the K sampled values + K packed levels."""
    return SEED_BITS + F32_BITS * nblk + qsgd_level_bits(s) * nblk * kb


def qsgd_global_bits(d: int, s: int) -> float:
    """Per-leaf QSGD (one global ℓ2 norm over the whole vector): f32 norm +
    one packed level per coordinate. Replaces the old ceil(log2(2s+1))
    entropy-coding estimate with what the packed wire actually ships."""
    return F32_BITS + qsgd_level_bits(s) * d


def natural_tree_bits(d: int) -> float:
    """Per-leaf natural compression: f32 reference exponent + int8 code per
    coordinate (the historical 9-bit sign+exponent estimate ignored that a
    byte-aligned wire cannot ship 9-bit symbols)."""
    return F32_BITS + INT8_BITS * d


def correlated_q_bits(d: int, s: int) -> float:
    """CorrelatedQ wire: f32 norm + one packed level per coordinate (the
    stratified dither is shared randomness, never transmitted)."""
    return F32_BITS + qsgd_level_bits(s) * d


# ---------------------------------------------------------------------------
# Partial-participation accounting (PP-MARINA, Alg. 4 — DESIGN.md §4.8)
#
# In the federated regime only the sampled cohort uploads: a compressed round
# costs exactly r·ζ_Q bits fleet-wide (r payloads, each the compressor's
# per-worker wire), a sync round costs n·32d (every client ships its dense
# local gradient). The ledgers book the PER-ROUND totals from these helpers
# and divide by n for the per-client average — so the loss-vs-bits x-axis
# (Figs. 1–2 shape) reflects the r/n uplink saving exactly, never an
# approximation smuggled in at the call site.
# ---------------------------------------------------------------------------


def pp_uplink_total_bits(r: int, zeta_bits):
    """Fleet-total uplink of one PP compressed round: r sampled clients ×
    one compressed payload each (Alg. 4 line 9 — the r·ζ_Q term of the
    Thm 4.1 communication complexity). ``zeta_bits`` is the per-worker
    payload from the per-format helpers above."""
    return r * zeta_bits


def pp_sync_total_bits(n: int, d: int) -> float:
    """Fleet-total uplink of one PP sync round: all n clients ship the dense
    f32 local gradient (Alg. 4 line 7)."""
    return n * dense_f32_bits(d)


def pp_expected_round_bits(p: float, n: int, r: int, d: int, zeta_bits):
    """Expected fleet-total uplink per PP round: p·n·32d + (1−p)·r·ζ_Q —
    the quantity Thm 4.1 trades against the iteration count."""
    return p * pp_sync_total_bits(n, d) + (1.0 - p) * pp_uplink_total_bits(
        r, zeta_bits
    )


# ---------------------------------------------------------------------------
# Downlink accounting (DESIGN.md §4.7)
#
# The server→worker direction was historically invisible to the ledger: every
# round broadcast the dense f32 estimator g^{k+1} (or equivalently the
# params) and booked zero bits. The bidirectional wire makes the direction
# explicit: sync rounds and unconfigured downlinks book the dense broadcast,
# compressed downlinks book the Q_down(g^{k+1} − g^k) payload — which reuses
# the per-sampler formats above (the payload is ONE worker-shaped message,
# n = 1), so there are no new per-format formulas to drift.
# ---------------------------------------------------------------------------


def downlink_dense_bits(d: int) -> float:
    """The uncompressed downlink: the dense f32 estimator broadcast each
    worker receives (sync rounds, and every round when no Q_down is set)."""
    return F32_BITS * d


def round_total_bits(up_bits_per_worker: float,
                     down_bits_per_worker: float) -> float:
    """Total up+down wire bits one worker moves in one round (the benchmark
    and ledger convention: per worker, both directions — multiply by n for
    the fleet)."""
    return up_bits_per_worker + down_bits_per_worker


# ---------------------------------------------------------------------------
# Bytes-by-link-tier ledger (DESIGN.md §7)
#
# A payload bit is not priced by its count alone but by WHICH link it
# crosses: host-loopback (fake-device single process), ici (intra-pod), or
# dcn (the cross-pod bandwidth cliff the compressed wires were built for).
# The transport layer books every collective it stages here, tagged by
# (scope, direction, tier, kind), so EXPERIMENTS.md and the multiproc bench
# can report "uplink bits on the dcn" rather than one flat number.
# ---------------------------------------------------------------------------

#: canonical link-tier names, fast → slow (launch/topology.py assigns them)
LINK_TIERS = ("loopback", "ici", "dcn")


@dataclasses.dataclass
class TierLedger:
    """Mutable bits-by-link-tier ledger the transport layer books into.

    Entries are keyed ``(scope, direction, tier, kind)``:

    * ``scope``     — which step traced the collective ("sync_step",
                      "compressed_step", …; the round-assembly layer scopes
                      each jitted step so one shared transport never
                      double-books across step entries),
    * ``direction`` — "up" (worker → server) or "down" (server → worker),
    * ``tier``      — one of :data:`LINK_TIERS`,
    * ``kind``      — the collective family ("all-gather", "all-to-all",
                      "psum", "broadcast", …).

    Booked values are BITS PER WORKER PER ROUND from the per-format helpers
    in this module — the ledger adds the *where*, never a second opinion on
    the *how much*.
    """

    bits: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)

    def book(self, scope: str, direction: str, tier: str, kind: str,
             bits: float) -> None:
        """Accumulate ``bits`` under ``(scope, direction, tier, kind)``.
        Direction must be "up"/"down"; tier must be a LINK_TIERS name."""
        assert direction in ("up", "down"), direction
        assert tier in LINK_TIERS, tier
        key = (scope, direction, tier, kind)
        self.bits[key] = self.bits.get(key, 0.0) + float(bits)
        self.counts[key] = self.counts.get(key, 0) + 1

    def total_bits(self, scope=None, direction=None, tier=None) -> float:
        """Sum booked bits, filtered by any of scope/direction/tier (None
        matches everything)."""
        return sum(
            v for (s, d, t, _k), v in self.bits.items()
            if (scope is None or s == scope)
            and (direction is None or d == direction)
            and (tier is None or t == tier)
        )

    def by_tier(self, scope=None) -> dict:
        """{tier: {direction: bits}} summary for one scope (or all)."""
        out: dict = {}
        for (s, d, t, _k), v in self.bits.items():
            if scope is not None and s != scope:
                continue
            out.setdefault(t, {}).setdefault(d, 0.0)
            out[t][d] += v
        return out

    def to_dict(self) -> dict:
        """JSON-serializable dump: ``{"scope/direction/tier/kind": bits}``
        plus per-key trace counts — what the bench artifacts persist."""
        return {
            "bits": {"/".join(k): v for k, v in self.bits.items()},
            "counts": {"/".join(k): v for k, v in self.counts.items()},
        }

    def clear(self) -> None:
        """Drop all bookings (used between benchmark configurations)."""
        self.bits.clear()
        self.counts.clear()
