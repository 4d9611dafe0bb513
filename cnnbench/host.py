"""The benchmark process's host settings, fixed before any work.

glibc hands a large block back to the operating system when it is freed
and maps it again when the next one is asked for, and its threshold for
doing so moves with the program's history. The serving loop allocates
several fresh 4.8 MB arrays a call (``np.zeros``, ``np.concatenate``,
``np.stack``), so each call faulted some 5,000 pages in anew on some
runs and none on others: on the card's machine, where a page fault is
dear, serve calls took 4.3 ms on some runs and 30 ms on others, on the
same seed (PERF.md §6). Fixing the thresholds (blocks up to 256 MiB from
the heap, freed memory kept up to 2 GiB) gives every run the first case.
"""
import ctypes
import ctypes.util

M_TRIM_THRESHOLD, M_TOP_PAD, M_MMAP_THRESHOLD = -1, -2, -3


def fix_malloc() -> bool:
    """Fix glibc's thresholds for this process; False where there is no
    glibc to tell."""
    name = ctypes.util.find_library("c")
    if not name:
        return False
    try:
        libc = ctypes.CDLL(name)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    return all(mallopt(k, v) == 1 for k, v in (
        (M_MMAP_THRESHOLD, 256 << 20), (M_TRIM_THRESHOLD, 2 << 30),
        (M_TOP_PAD, 64 << 20)))
