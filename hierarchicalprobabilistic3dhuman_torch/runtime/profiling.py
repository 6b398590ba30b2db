"""The port's tracing: one torch.profiler exporter behind the CLIs'
--profile_dir flag (absent in the reference, SURVEY section 5), and the
program's own spans and counters.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/runtime/profiling.py
(trace :15): `trace` wraps torch.profiler where the JAX package wraps
jax.profiler, and writes one Chrome trace (open it in Perfetto or
chrome://tracing).

Spans and counters (`span`, `count`) mark where the program's layers do
their host work: a train step's stages, the pose head, the predict calls,
the eval step, the loader's take, and the deliberate blocking reads
(`host_syncs`). They record only while a torch.profiler session runs in the
process (`trace`, or any other `torch.profiler.profile`); at any other time
a span is one attribute read and a shared no-op context, and makes no CUDA
call. A record holds host start and end on `time.time_ns`, the clock the
profiler stamps device activity on, so records join the device trace by
time. Records stay in memory, up to MAX_RECORDS (later ones are dropped and
counted); `spans_between` reads them.

The profiler keeps every event in memory until the block ends and then
writes them all: a training step at B = 72 makes some 39,000 device
launches, so trace a few steps, not a whole run.
"""

import contextlib
import json
import os
import re
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_NAME = "trace.json"
MAX_RECORDS = 200_000
# A span while no profiler session runs.
_NO_SPAN = contextlib.nullcontext()


class SpanRecord:
    """One span: `index` in the recorder, `name`, host `start_ns` and
    `end_ns` (time.time_ns; None while open), the index of its `parent`
    (None for a root), the index of its `root` (itself for a root; the
    spans of one step share it), the OS `thread` id, and its `counters`
    ({name: total}). A count made while no span is open is a record of its
    own, with start == end and its counter."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "root",
                 "thread", "counters")

    def __init__(self, index, name, start_ns, parent, root, thread):
        self.index = index
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.parent = parent
        self.root = index if root is None else root
        self.thread = thread
        self.counters = {}


class _Span:
    __slots__ = ("recorder", "name")

    def __init__(self, recorder, name):
        self.recorder = recorder
        self.name = name

    def __enter__(self):
        self.recorder._open(self.name)

    def __exit__(self, *exc):
        self.recorder._close()


class SpanRecorder:
    """The process's span records, each thread with its own stack of open
    spans."""

    def __init__(self, max_records=MAX_RECORDS):
        self.max_records = max_records
        self.records = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _thread(self):
        """This thread's stack of open spans and its OS id (read once: a
        system call)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.thread = [], threading.get_native_id()
        return local.stack, local.thread

    def _new(self, name, parent, thread):
        """A record appended under the lock, or None past the bound (a
        dropped record, counted)."""
        with self._lock:
            if len(self.records) >= self.max_records:
                self.dropped += 1
                return None
            rec = SpanRecord(len(self.records), name, time.time_ns(),
                             None if parent is None else parent.index,
                             None if parent is None else parent.root, thread)
            self.records.append(rec)
            return rec

    def _open(self, name):
        stack, thread = self._thread()
        # Under a dropped span (None) the list is full: this one is dropped too.
        stack.append(self._new(name, stack[-1] if stack else None, thread))

    def _close(self):
        rec = self._local.stack.pop()
        if rec is not None:
            rec.end_ns = time.time_ns()

    def span(self, name):
        """A context manager: a span named `name`, recorded only while a
        torch.profiler session runs."""
        # torch rebinds the flag, a module global: read it through the module.
        if not _autograd_profiler._is_profiler_enabled:
            return _NO_SPAN
        return _Span(self, name)

    def count(self, name, n=1):
        """Add n to counter `name` of the innermost open span of this
        thread, or, with none open, record it on a record of its own; only
        while a torch.profiler session runs."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        stack, thread = self._thread()
        if stack:
            rec = stack[-1]
        else:
            rec = self._new(name, None, thread)
            if rec is not None:
                rec.end_ns = rec.start_ns
        if rec is not None:
            rec.counters[name] = rec.counters.get(name, 0) + n

    def spans_between(self, t0_ns, t1_ns):
        """The closed records that start and end in [t0_ns, t1_ns]."""
        return [r for r in list(self.records)
                if r.end_ns is not None and t0_ns <= r.start_ns
                and r.end_ns <= t1_ns]


RECORDER = SpanRecorder()
span = RECORDER.span
count = RECORDER.count
spans_between = RECORDER.spans_between


def merge_spans(path, records, dropped=0):
    """Add `records` to the Chrome trace at `path` as complete events of a
    process of their own ("program spans"), one row a host thread, on the
    trace's own time base (its `baseTimeNanoseconds`, or 0 where a version
    writes none), with `programSpansDropped` beside `traceEvents`.

    torch.profiler writes `traceEvents` last but for the trace's name, so
    the events go in before its closing bracket, and a trace of millions of
    device events is not parsed and written again; a file that ends
    otherwise is."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    base = int(m.group(1)) if m else 0
    events = [{"ph": "X", "cat": "program_span", "name": r.name,
               "pid": "program spans", "tid": r.thread,
               "ts": (r.start_ns - base) / 1e3,
               "dur": (r.end_ns - r.start_ns) / 1e3,
               "args": {"index": r.index, "parent": r.parent, "root": r.root,
                        **r.counters}} for r in records]
    with open(path, "r+b") as f:
        size = f.seek(0, os.SEEK_END)
        start = f.seek(max(0, size - (1 << 16)))
        tail = f.read()
        end = tail.rfind(b"]")
        rest = tail[end + 1:]
        try:
            # After traceEvents' bracket: the rest of the top-level object.
            json.loads(b'{"traceEvents": []' + rest)
        except ValueError:
            end = -1
        if end >= 0:
            inner = b",\n".join(json.dumps(e).encode() for e in events)
            empty = tail[:end].rstrip().endswith(b"[")
            f.seek(start + end)
            f.write((b"" if empty or not inner else b",\n") + inner
                    + b'\n], "programSpansDropped": %d' % dropped + rest)
            return
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(events)
    doc["programSpansDropped"] = dropped
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(profile_dir, device="cpu"):
    """Record the enclosed block with torch.profiler and write
    `profile_dir`/trace.json, also when the block raises (as jax.profiler's
    trace is stopped): on a CUDA device the card's kernels, copies and
    memsets alone (the CPU's operators too would double the events the
    profiler processes and writes once the block ends), elsewhere the CPU's
    operators; with the program's spans of the block merged in on the same
    clock. A no-op when profile_dir is None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.time_ns()
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        t1 = time.time_ns()
        path = os.path.join(profile_dir, TRACE_NAME)
        prof.export_chrome_trace(path)
        merge_spans(path, spans_between(t0, t1), RECORDER.dropped)
