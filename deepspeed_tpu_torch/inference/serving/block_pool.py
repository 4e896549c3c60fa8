"""Host-side accounting for the paged KV-cache block pool.

Counterpart of ``deepspeed_tpu/inference/serving/block_pool.py``, cut to
what this slice of the port runs: a page is blank or owned by exactly one
request. The JAX pool's reference sets, content index, cached LRU,
copy-on-write, host tier and defrag serve the prefix cache and the KV
tiers; ``ServingConfig`` rejects both until the slices that port them
(ROADMAP.md Queue 1), and that code arrives with them.

The device arrays (``models/layers.py init_paged_kv_cache``) are a flat pool
of ``num_blocks`` pages; this class owns WHICH page belongs to WHICH
request. Every transition is validated, so leaks and double-frees are
structural errors (raised immediately), not silent capacity rot.
"""

from typing import Dict, List


class BlockPoolError(RuntimeError):
    """A block-accounting invariant was violated (double-free, foreign free,
    allocation beyond capacity)."""


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # popping from the tail keeps allocation ascending-ish (cosmetic)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        #: the request id holding each allocated page
        self._owner: Dict[int, str] = {}

    # -- capacity ------------------------------------------------------

    @property
    def sentinel(self) -> int:
        """Block-table entry meaning "unallocated": one past the pool, so
        appends routed there fall out of bounds and are dropped."""
        return self.num_blocks

    def blocks_for_tokens(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` positions (>= 1)."""
        return max(1, -(-num_tokens // self.block_size))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Pages held by a request."""
        return len(self._owner)

    def occupancy(self) -> float:
        return self.used_count / self.num_blocks

    def can_allocate(self, n: int) -> bool:
        return n <= self.free_count

    # -- transitions ---------------------------------------------------

    def allocate(self, n: int, owner: str) -> List[int]:
        """Hand ``owner`` n pages."""
        if n < 0:
            raise ValueError(f"allocate({n})")
        if n > self.free_count:
            raise BlockPoolError(f"pool exhausted: want {n} blocks, "
                                 f"{self.free_count} free")
        out = [self._free.pop() for _ in range(n)]
        for bid in out:
            self._owner[bid] = owner
        return out

    def free(self, block_ids: List[int], owner: str) -> None:
        """Return ``owner``'s pages to the blank list. Double frees and
        foreign frees raise before anything mutates."""
        seen = set()
        for bid in block_ids:
            held = self._owner.get(bid)
            if held is None or bid in seen:
                raise BlockPoolError(f"double free of block {bid} ({owner})")
            if held != owner:
                raise BlockPoolError(
                    f"block {bid} owned by {held!r}, freed by {owner!r}")
            seen.add(bid)
        for bid in block_ids:
            del self._owner[bid]
            self._free.append(bid)

    # -- invariants ----------------------------------------------------

    def check_consistent(self) -> None:
        """Every page in exactly one place (blank or owned); raises on any
        accounting leak."""
        free = set(self._free)
        used = set(self._owner)
        if len(free) != len(self._free):
            raise BlockPoolError("free list holds duplicates")
        if free & used:
            raise BlockPoolError(f"blocks both free and owned: "
                                 f"{sorted(free & used)}")
        if len(free) + len(used) != self.num_blocks:
            missing = set(range(self.num_blocks)) - free - used
            raise BlockPoolError(f"leaked blocks: {sorted(missing)}")
