"""What a metric reads of the program's own spans.

The port keeps a record of each of its spans while a torch.profiler
profile runs (aligngraph_tpu_torch/utils/spans.py, read out by
spans.records()), so a traced run leaves the spans of its traced steps
there and of no other step.  A root span is one sample (a run_pipeline
call) or one aligner call made outside a sample.  A checkout whose port
has no such recorder gives nothing to read.
"""

from __future__ import annotations


def mean_per_root(run, root: str, names: tuple, field: str = "host_s"):
    """The mean over the traced steps' root spans named `root` of the
    summed `field` ("host_s" or "device_s") of the spans named in
    `names` within each (None without such roots or values)."""
    try:
        from aligngraph_tpu_torch.utils import spans
    except ImportError:
        return None
    n = sum(1 for s in run.steps if s["traced"])
    recs = spans.records()
    roots = [r["id"] for r in recs
             if r["parent"] is None and r["name"] == root][-n:] if n else []
    if not roots:
        return None
    sums = dict.fromkeys(roots, 0.0)
    for r in recs:
        if r["sample"] in sums and r["name"] in names:
            if r[field] is None:
                return None
            sums[r["sample"]] += r[field]
    return sum(sums.values()) / len(sums)
