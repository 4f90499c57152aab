"""Stage (5)'s host-only steps in a traced call: the host seconds of the
spans misassembly.formalize (the drafts read from FASTA), .placement_loops
(the filter, conflict, close-merge, cross-chromosome and split loops),
.sweep_split (removeMasb's sweep and split) and .write (the corrected
FASTA), summed, a call."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(
        run, "misassembly", ("misassembly.formalize",
                             "misassembly.placement_loops",
                             "misassembly.sweep_split", "misassembly.write"))
