"""The device memory one call holds: the port's counterpart of XLA's
``memory_analysis`` (``compiled.memory_analysis()`` in the reference's
dry run), counted as the call runs, the same on meta, the CPU and the
card.

:class:`MemoryCounter` is a dispatch mode. At entry it counts the distinct
storages reachable from the call's arguments on its device (each argument
at the share of its bytes the device holds: the dry run hands a step the
global batch, of which a device holds its rows). Then every operator
output whose storage is new adds its bytes, rounded up to the CUDA caching
allocator's 512 B; views, in-place ops and ``out=`` add nothing, and
allocations (``empty`` and its kin) add theirs. A storage's bytes leave
the live count when the storage dies: the death of its Python object marks
it (PyTorch mostly keeps that object as long as the storage; where it goes
first, as a meta ``empty``'s does, the storage is marked early and stays
marked until it dies), and ``StorageWeakRef.expired`` confirms the death.
No operator scans the live storages, and the marked ones are confirmed
only when an allocation could set a new peak: until then the live count
may hold storages that died, so it is an upper bound, and below the peak
an upper bound sets nothing; above it, the confirmed count decides. So the
peak is exact. The peak of the live count, the operator at which it was
reached and the bytes live there by the operator that allocated them
(``peak_by_op``) give :meth:`MemoryCounter.analysis`: the reference's five
keys, ``temp_size_in_bytes`` = peak − argument − output + alias, so that
the reference's formula gives the peak back.

A kernel wrapper decorated with :func:`kernel_call` counts as one call
that allocates its outputs and nothing else, on every device: on the card
the kernel allocates exactly its outputs; off the card its plain version
runs in its place, and its temporaries (a dense gather of a paged cache,
int64 counters) are not what the card would hold. What the program builds
under :func:`shapes_only` counts nothing: meta tensors that carry a shape
(a layer's whole leaves, the ledger's booked shapes), which a card run
never allocates and a meta run cannot tell from the device's tensors.

The counter counts what the port's eager program allocates and frees, not
a compiler's buffer assignment: lifetimes follow Python references and the
autograd graph's saved tensors. The card's allocator adds what no operator
returns (cuBLAS workspaces, buffers an operator frees before it returns)
and the unsplit tails of its cached blocks.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Optional, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the CUDA caching allocator's rounding of a request, bytes
ROUND = 512

#: the counters counting now, innermost last (read by :func:`kernel_call`)
_ACTIVE: list = []
#: how many :func:`shapes_only` blocks the program is inside
_SHAPES_ONLY = [0]
#: how far the card allocator's peak may lie above the counted one: what
#: no operator returns (cuBLAS's 32 MiB workspace, made by a stream's first
#: GEMM) and the unsplit tails of the allocator's blocks; every gap measured
#: on an H100 lay in [0, 78.4 MB]
TOLERANCE_ABOVE = 128 * 2**20
#: how far it may lie below: the count holds nothing the allocator does not
#: (no gap measured was negative), less the 512-B rounding of 2,048 storages
TOLERANCE_BELOW = 2**20


def rounded(nbytes: int) -> int:
    """``nbytes`` as the caching allocator books it (0 stays 0)."""
    return -(-nbytes // ROUND) * ROUND


def _leaves(tree) -> list:
    """The tensors of a step's arguments or outputs (any pytree)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _tensors(tree) -> list:
    """The tensors of an operator's arguments or outputs: tensors, lists,
    tuples and dicts of them (an operator's own structures; a pytree walk
    would cost more than the counting)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """An operator whose outputs alias an input (views, in-place, ``out=``)."""
    return any(r.alias_info is not None for r in func._schema.returns)


@contextlib.contextmanager
def shapes_only():
    """A block (or, called, a decorator) whose tensors carry shapes only:
    no counter counts what it allocates (module doc)."""
    _SHAPES_ONLY[0] += 1
    try:
        yield
    finally:
        _SHAPES_ONLY[0] -= 1


def kernel_call(wrapper):
    """Decorate a kernel wrapper: under a :class:`MemoryCounter` a call
    counts its outputs' bytes and nothing it allocates inside (module doc)."""
    @functools.wraps(wrapper)
    def call(*args, **kwargs):
        if not _ACTIVE:
            return wrapper(*args, **kwargs)
        return _ACTIVE[-1].kernel(wrapper, args, kwargs)
    return call


class MemoryCounter(TorchDispatchMode):
    """Live device bytes of a call (module doc). ``args`` are the call's
    arguments, ``shares`` the fraction of each argument's storage bytes the
    device holds (1 each by default). The device counted is the first
    tensor argument's (every device without one)."""

    def __init__(self, args: Sequence = (), shares: Optional[Sequence[float]] = None):
        super().__init__()
        self.device = next((t.device.type for t in _leaves(args)), None)
        self._args: set = set()    # cdata of the argument storages
        self.argument = 0
        shares = [1.0] * len(args) if shares is None else list(shares)
        for arg, share in zip(args, shares, strict=True):
            held = 0
            for t in _leaves(arg):
                st = self._storage(t)
                if st is not None and st._cdata not in self._args:
                    self._args.add(st._cdata)
                    held += st.nbytes()
            self.argument += int(held * share)
        self._bytes = self.peak = self.argument
        self.peak_op: Optional[str] = None
        # the live bytes by the operator that allocated them, now and at the peak
        self._by_op: dict = {}
        self.peak_by_op: dict = {}
        self._live: dict = {}      # cdata -> [StorageWeakRef, weakref, exact, counted, op]
        self._marked: set = set()  # cdata whose Python object died
        self._kernel_depth = 0

    @property
    def live(self) -> int:
        """The bytes live now (argument share included)."""
        self._settle()
        return self._bytes

    # -- storages -----------------------------------------------------------

    def _storage(self, t: torch.Tensor):
        if self.device is not None and t.device.type != self.device:
            return None
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError):   # no storage (sparse, nested)
            return None

    def _known(self, cdata: int) -> bool:
        return cdata in self._live or cdata in self._args

    def _add(self, st, exact: int, where: str) -> None:
        counted = rounded(exact)
        if self._bytes + counted > self.peak and self._marked:
            self._settle()   # the count is an upper bound until settled (module doc)
        cd = st._cdata
        ref = weakref.ref(st, functools.partial(self._died, cd))
        self._live[cd] = [StorageWeakRef(st), ref, exact, counted, where]
        self._bytes += counted
        self._by_op[where] = self._by_op.get(where, 0) + counted
        if self._bytes > self.peak:
            self.peak, self.peak_op = self._bytes, where
            self.peak_by_op = {op: n for op, n in self._by_op.items() if n}

    def _died(self, cdata: int, _ref) -> None:
        if cdata in self._live:
            self._marked.add(cdata)

    def _settle(self) -> None:
        """Free the marked storages that have died."""
        for cd in [cd for cd in self._marked if self._live[cd][0].expired()]:
            self._marked.discard(cd)
            entry = self._live.pop(cd)
            self._bytes -= entry[3]
            self._by_op[entry[4]] -= entry[3]

    # -- the dispatch mode --------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._kernel_depth or _SHAPES_ONLY[0] or _is_view(func):
            return out
        new = [(t, st) for t in _tensors(out)
               if (st := self._storage(t)) is not None and not self._known(st._cdata)]
        if new:
            ins = {st._cdata for t in _tensors((args, kwargs))
                   if (st := self._storage(t)) is not None}
            name = func.overloadpacket.__name__
            for _t, st in new:
                if st._cdata not in ins and not self._known(st._cdata):
                    self._add(st, st.nbytes(), name)
        return out

    def kernel(self, wrapper, args, kwargs):
        """One kernel call (:func:`kernel_call`): its new outputs' bytes."""
        self._kernel_depth += 1
        try:
            out = wrapper(*args, **kwargs)
        finally:
            self._kernel_depth -= 1
        if self._kernel_depth or _SHAPES_ONLY[0]:
            return out
        ins = {st._cdata for t in _tensors((args, kwargs))
               if (st := self._storage(t)) is not None}
        sizes: dict = {}
        for t in _tensors(out):
            st = self._storage(t)
            if st is not None and st._cdata not in ins and not self._known(st._cdata):
                st0, n = sizes.get(st._cdata, (st, 0))
                sizes[st._cdata] = (st0, min(n + t.numel() * t.element_size(), st.nbytes()))
        for st, n in sizes.values():
            self._add(st, n, wrapper.__name__)
        return out

    # -- the result ---------------------------------------------------------

    def analysis(self, out) -> dict:
        """The reference's ``memory_analysis`` keys for the call that
        returned ``out`` (call while ``out`` is alive)."""
        self._settle()
        output = alias = 0
        seen = set()
        for t in _leaves(out):
            st = self._storage(t)
            if st is None or st._cdata in seen:
                continue
            seen.add(st._cdata)
            if st._cdata in self._live:
                output += self._live[st._cdata][2]
            else:
                output += st.nbytes()
                alias += st.nbytes() if st._cdata in self._args else 0
        return {
            "argument_size_in_bytes": float(self.argument),
            "output_size_in_bytes": float(output),
            "alias_size_in_bytes": float(alias),
            "temp_size_in_bytes": float(self.peak - self.argument - output + alias),
            "generated_code_size_in_bytes": 0.0,
        }


def counted_peak(analysis: dict) -> float:
    """The peak of a ``memory_analysis`` dict: temp + argument + output −
    alias, the reference's formula."""
    return (analysis["temp_size_in_bytes"] + analysis["argument_size_in_bytes"]
            + analysis["output_size_in_bytes"] - analysis["alias_size_in_bytes"])


def against_allocator(entry: dict) -> Optional[dict]:
    """A card record's counted peak beside its allocator's (a step entry
    with ``memory_analysis``, ``peak_memory_per_device`` and
    ``allocated_at_entry``; None without the last): the allocator's peak
    less what it held at entry beyond the step's arguments, the gap
    (allocator − counted) and whether it lies within
    [−:data:`TOLERANCE_BELOW`, :data:`TOLERANCE_ABOVE`]."""
    ma, at = entry.get("memory_analysis"), entry.get("allocated_at_entry")
    if ma is None or at is None:
        return None
    allocator = entry["peak_memory_per_device"] - at + ma["argument_size_in_bytes"]
    counted = counted_peak(ma)
    gap = allocator - counted
    return {"counted": counted, "allocator": allocator, "gap": gap,
            "tolerance": [-TOLERANCE_BELOW, TOLERANCE_ABOVE],
            "within": -TOLERANCE_BELOW <= gap <= TOLERANCE_ABOVE}
