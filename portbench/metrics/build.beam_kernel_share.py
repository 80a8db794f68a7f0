"""build.beam_kernel_share (fraction): the graph builder's insert rounds whose
construction beam ran in the port's beam kernel (csrc/hnsw_beam.cu), over all
insert rounds of the run: the port's counters `build.beam_kernel` over
`build.insert_rounds`. A port that has no `build.beam_kernel` counter gives
nothing."""

from portbench import program_spans


def read(ctx):
    tr = program_spans.facility()
    if tr is None:
        return None
    counts = tr.counters()
    rounds = counts.get("build.insert_rounds", 0)
    if not rounds or "build.beam_kernel" not in counts:
        return None
    return counts["build.beam_kernel"] / rounds
