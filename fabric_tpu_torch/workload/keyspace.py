"""Zipf-skewed keyspace + traffic mix: WHAT each arrival touches.

Key access in real permissioned-ledger deployments is heavily skewed —
a few hot assets absorb most writes — and skew is exactly what turns
load into MVCC conflict storms: two in-flight txs that endorsed the
same hot key's version race, and every loser burns a full
endorse/order/validate round just to be flagged MVCC_READ_CONFLICT.
This module makes that a dial, not an accident:

  ZipfSampler(n, s, seed)   rank-frequency key draw, p(k) ~ 1/k^s.
                            s=0 is uniform (conflicts ~ birthday
                            bound), s>=1.2 hammers a handful of keys.
  TrafficMix                channel/chaincode weights + a read/write/
                            range op blend, one seeded PRNG, so a
                            multi-tenant workload is reproducible
                            draw-for-draw.

`expected_collision_p(n, s)` is the analytic conflict dial — the
probability two independent draws pick the same key (sum p_i^2) —
monotone in s, which the tests pin so "turn s up, get more conflicts"
stays true as samplers evolve.

Counterpart of `fabric_tpu/workload/keyspace.py`, whole; stdlib only.
"""

from __future__ import annotations

import bisect
import random
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["ZipfSampler", "Op", "TrafficMix", "expected_collision_p"]

OP_KINDS = ("read", "write", "range")


def _zipf_weights(n: int, s: float) -> List[float]:
    return [1.0 / (k ** s) for k in range(1, n + 1)]


def expected_collision_p(n: int, s: float) -> float:
    """P(two independent Zipf(s) draws over n keys collide) = sum p_i^2.

    The analytic form of the MVCC conflict dial: strictly increasing in
    s for n > 1 (mass concentrates on low ranks), so a workload's
    conflict rate is tunable by skew alone at a fixed offered rate."""
    w = _zipf_weights(n, s)
    total = sum(w)
    return sum((x / total) ** 2 for x in w)


class ZipfSampler:
    """Seeded Zipf(s) rank sampler over n keys via inverse-CDF bisect.

    Rank 1 is the hottest key.  `key(rank)` maps ranks to stable key
    strings so independent samplers over the same n collide on the
    same hot set (what a multi-client conflict storm needs)."""

    def __init__(self, n: int, s: float = 1.0, seed: int = 0,
                 prefix: str = "k"):
        if n < 1:
            raise ValueError("ZipfSampler needs n >= 1")
        self.n = int(n)
        self.s = float(s)
        self.seed = int(seed)
        self.prefix = prefix
        self._rand = random.Random(self.seed)
        w = _zipf_weights(self.n, self.s)
        total = sum(w)
        self._cdf: List[float] = []
        acc = 0.0
        for x in w:
            acc += x / total
            self._cdf.append(acc)
        self._cdf[-1] = 1.0           # guard float drift at the tail

    def rank(self) -> int:
        """One draw -> rank in [1, n] (1 = hottest)."""
        return bisect.bisect_left(self._cdf, self._rand.random()) + 1

    def key(self, rank: Optional[int] = None) -> str:
        r = self.rank() if rank is None else rank
        return f"{self.prefix}{r:06d}"

    def pmf(self, rank: int) -> float:
        lo = self._cdf[rank - 2] if rank >= 2 else 0.0
        return self._cdf[rank - 1] - lo


class Op:
    """One generated operation: where it goes and what it touches."""

    __slots__ = ("channel", "chaincode", "kind", "key", "end_key",
                 "client_id")

    def __init__(self, channel: str, chaincode: str, kind: str, key: str,
                 end_key: Optional[str] = None,
                 client_id: Optional[int] = None):
        self.channel = channel
        self.chaincode = chaincode
        self.kind = kind
        self.key = key
        self.end_key = end_key
        self.client_id = client_id

    def as_dict(self) -> dict:
        return {"channel": self.channel, "chaincode": self.chaincode,
                "kind": self.kind, "key": self.key,
                "end_key": self.end_key, "client_id": self.client_id}

    def __repr__(self) -> str:
        return (f"Op({self.kind} {self.channel}/{self.chaincode} "
                f"{self.key})")


class TrafficMix:
    """Weighted multi-channel traffic with a read/write/range blend.

    channels: [{"channel": "ch", "chaincode": "assets", "weight": 1.0,
                "keys": 1000, "zipf_s": 1.0,
                "blend": {"read": .3, "write": .6, "range": .1}}]

    One seeded PRNG drives channel choice, op-kind choice, and every
    per-channel key draw (each channel's ZipfSampler is sub-seeded from
    the mix seed + channel index), so a mix is reproducible end-to-end
    from a single integer.
    """

    def __init__(self, channels: Sequence[dict], seed: int = 0):
        if not channels:
            raise ValueError("TrafficMix needs at least one channel")
        self.seed = int(seed)
        self._rand = random.Random(self.seed)
        self.entries: List[dict] = []
        self._samplers: List[ZipfSampler] = []
        weights: List[float] = []
        for i, c in enumerate(channels):
            ent = {"channel": str(c.get("channel", "ch")),
                   "chaincode": str(c.get("chaincode", "assets")),
                   "weight": float(c.get("weight", 1.0)),
                   "keys": int(c.get("keys", 1024)),
                   "zipf_s": float(c.get("zipf_s", 1.0)),
                   "blend": dict(c.get("blend")
                                 or {"read": 0.2, "write": 0.8,
                                     "range": 0.0})}
            bad = set(ent["blend"]) - set(OP_KINDS)
            if bad:
                raise ValueError(f"unknown op kinds {sorted(bad)} "
                                 f"(one of {OP_KINDS})")
            self.entries.append(ent)
            weights.append(ent["weight"])
            self._samplers.append(ZipfSampler(
                ent["keys"], ent["zipf_s"], seed=self.seed * 7919 + i,
                prefix=f"{ent['channel']}-"))
        total = sum(weights)
        if total <= 0.0:
            raise ValueError("channel weights sum to zero")
        self._chan_cdf: List[float] = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._chan_cdf.append(acc)
        self._chan_cdf[-1] = 1.0

    def _pick_kind(self, blend: Dict[str, float]) -> str:
        total = sum(blend.values())
        if total <= 0.0:
            return "write"
        r = self._rand.random() * total
        acc = 0.0
        for kind in OP_KINDS:
            acc += blend.get(kind, 0.0)
            if r < acc:
                return kind
        return "write"

    def next_op(self) -> Op:
        i = bisect.bisect_left(self._chan_cdf, self._rand.random())
        ent = self.entries[i]
        sampler = self._samplers[i]
        kind = self._pick_kind(ent["blend"])
        rank = sampler.rank()
        key = sampler.key(rank)
        end_key = None
        if kind == "range":
            # a short scan window starting at the drawn rank: ranges
            # collide with writes landing anywhere inside the window,
            # which is what drives phantom-read conflicts
            end = min(ent["keys"], rank + 8)
            end_key = sampler.key(end)
        return Op(ent["channel"], ent["chaincode"], kind, key,
                  end_key=end_key)

    def ops(self, n: int) -> List[Op]:
        return [self.next_op() for _ in range(n)]

    def conflict_dial(self) -> float:
        """Weighted expected same-key collision probability across the
        mix — the single-number conflict dial for reports."""
        total_w = sum(e["weight"] for e in self.entries)
        return sum(
            (e["weight"] / total_w)
            * expected_collision_p(e["keys"], e["zipf_s"])
            for e in self.entries)

    def describe(self) -> dict:
        return {"seed": self.seed, "channels": [dict(e)
                                                for e in self.entries],
                "conflict_dial": round(self.conflict_dial(), 6)}
