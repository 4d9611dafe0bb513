"""loop_ms.serve: host ms a serve call outside its rounds and its report:
the ``serve`` span's self time (admission, the loop's Python, completions),
its duration less what its child spans cover, averaged over the traced
window's calls: the program's host spans."""
from cnnbench.spans import loop_ms, window


def read(ctx):
    spans = window(ctx)
    return loop_ms(spans) if spans else None
