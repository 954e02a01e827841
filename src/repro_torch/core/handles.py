"""Collective handles: the object-capability face of ``register()``.

``OcclRuntime.register`` returns a :class:`CollectiveHandle` — an ``int``
subclass, so every pre-existing call site that threads the bare
``coll_id`` through ``submit``/``read_output``/dict keys keeps working
unchanged — that additionally owns the collective's operations
(``submit``/``submit_all``/``write``/``read``/``stats``) and, crucially,
survives **re-registration after an elastic shrink**: ``evict(rank)``
rebuilds every registration for R-1 ranks and the handle transparently
re-resolves to its post-shrink collective id via its registration-log
index.  Raw ints cannot do that — they go stale the moment the id space
is rebuilt — which is why eviction forced this API.

Plain-int call paths remain accepted everywhere as thin deprecated
shims (``runtime._resolve_cid``); they are only guaranteed against the
CURRENT registration generation.
"""
from __future__ import annotations


class CollectiveHandle(int):
    """An ``int``-compatible capability for one registered collective.

    The integer value is the collective id at REGISTRATION time; method
    calls and post-shrink uses resolve through the runtime's
    registration log instead, so the handle follows the collective
    across ``evict()`` rebuilds.
    """

    def __new__(cls, cid: int, runtime, reg_index: int):
        h = super().__new__(cls, cid)
        h._runtime = runtime
        h.reg_index = int(reg_index)
        return h

    def __repr__(self):
        return f"CollectiveHandle({int(self)}, reg_index={self.reg_index})"

    # NamedTuple/int semantics: hashing and equality stay value-based so
    # handles keep working as dict keys mixed with plain ints.

    @property
    def coll_id(self) -> int:
        """Current (post-shrink) collective id; raises if evicted away."""
        return self._runtime._current_cid(self.reg_index)

    @property
    def alive(self) -> bool:
        """False once a shrink dissolved this registration (e.g. every
        surviving member was evicted or the registration could not be
        rebuilt for the smaller group)."""
        try:
            self._runtime._current_cid(self.reg_index)
            return True
        except Exception:
            return False

    # -- owned operations (delegate to the runtime) ---------------------
    def submit(self, rank: int, prio: int = 0, data=None, callback=None,
               in_off: int = -1, out_off: int = -1):
        return self._runtime.submit(rank, self, prio=prio, data=data,
                                    callback=callback, in_off=in_off,
                                    out_off=out_off)

    def submit_all(self, prio: int = 0, data=None, callback=None):
        return self._runtime.submit_all(self, prio=prio, data=data,
                                        callback=callback)

    def write(self, rank: int, data, in_off: int = -1):
        return self._runtime.write_input(rank, self, data, in_off=in_off)

    def read(self, rank: int, out_off: int = -1):
        return self._runtime.read_output(rank, self, out_off=out_off)

    def stats(self) -> dict:
        return self._runtime.collective_stats(self)
