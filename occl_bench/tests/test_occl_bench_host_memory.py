"""The run's host allocator setting (``run.keep_freed_host_memory``), on a
stand-in for glibc: the real one is never set from a test."""
import occl_bench_tiny  # noqa: F401  (src/ and the root on sys.path)
from occl_bench import run


class Libc:
    def __init__(self, answer):
        self.answer, self.calls = answer, []

    def mallopt(self, param, value):
        self.calls.append((param, value))
        return self.answer


def test_heap_only_and_never_trimmed():
    libc = Libc(1)
    assert run.keep_freed_host_memory(libc).startswith(
        "host allocator keeps what it frees")
    assert libc.calls == [(run.M_MMAP_MAX, 0),
                          (run.M_TRIM_THRESHOLD, 2**31 - 1)]


def test_a_refusal_leaves_the_allocator_and_says_so():
    libc = Libc(0)
    assert run.keep_freed_host_memory(libc) == \
        "host allocator left as it is: mallopt refused"
    assert libc.calls == [(run.M_MMAP_MAX, 0)]


def test_a_libc_without_mallopt_is_left_as_it_is():
    assert run.keep_freed_host_memory(object()) == \
        "host allocator left as it is: no mallopt"
