"""End-to-end pipeline driver — L5/L6 (`main`, AlignGraph.cpp:4696-4796).

Stage graph (mirrors the reference's (0)-(6) banners):
  (0) input formalization (reads / contigs / genome)
  (1) alignment: in-engine PE read aligner + contig aligner over the whole
      concatenated genome (replacing bowtie2 + pblat subprocesses; the
      reference's 2-pthread fork becomes two device dispatch streams)
  (2) optional ratio check (C25)
  (3) per chromosome-part: graph build (contig + k-mer layers) ->
      extension -> scaffolding
  (4) refinement (final selection)
  (5) optional misassembly removal
Checkpointing (C15) is stage+part granular via pipeline/checkpoint.py.

PyTorch port: a copy of aligngraph_tpu/pipeline/driver.py (which imports
the JAX aligners) with the port's ReadAligner and ContigAligner on
`device`, sharing one seed index built on the host, and with
cfg.graph_build="device" the port's k-mer layer build
(graph/kmer_layer_jit.py) on `device`.  The contig layer, the host k-mer
build, traversal, checkpointing and stage files are the port's own copies
of the JAX package's host modules.
"""

from __future__ import annotations

import dataclasses
import os
import resource
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aligngraph_tpu_torch import native
from aligngraph_tpu_torch.align.types import ContigAlignments, PairAlignments
from aligngraph_tpu_torch.config import Config, THRESHOLD
from aligngraph_tpu_torch.graph.contig_layer import build_contig_layer, \
    initial_contigs
from aligngraph_tpu_torch.graph.kmer_layer import KmerBuildStats, \
    build_kmer_layer
from aligngraph_tpu_torch.graph.model import GraphTensors
from aligngraph_tpu_torch.graph.traverse import extend_and_scaffold
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import (Contigs, Genome, Reads,
                                               formalize_contigs,
                                               formalize_genome,
                                               formalize_reads)
from aligngraph_tpu_torch.utils import heap
from aligngraph_tpu_torch.utils.log import stage_banner, get_logger, log_memory
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.graph.kmer_layer_jit import (
    CHUNK_RECORDS, MAX_K, build_kmer_layer_device)
from aligngraph_tpu_torch.ops.seeding import build_index
from aligngraph_tpu_torch.pipeline.refinement import RefinementResult, refine

log = get_logger(__name__)


@dataclasses.dataclass
class PipelineResult:
    extended_ids: List[str]
    extended_seqs: List[np.ndarray]
    remaining_ids: List[str]
    remaining_seqs: List[np.ndarray]
    per_part_scaffolds: List[List[np.ndarray]]
    per_part_initials: List[List[Tuple[int, np.ndarray]]]
    stats: Dict
    wall_seconds: float = 0.0
    align_seconds: float = 0.0


def _subset_pairs(pa: PairAlignments, mask: np.ndarray) -> PairAlignments:
    return dataclasses.replace(
        pa, **{f.name: getattr(pa, f.name)[mask]
               for f in dataclasses.fields(pa)})


def _record_bytes(pa: PairAlignments) -> Dict:
    """_StageMemory.end's arrays of a record set: its pos_map apart."""
    return dict(rali_pos_map=pa.pos_map, rali=[
        getattr(pa, f.name) for f in dataclasses.fields(pa)
        if f.name != "pos_map"])


def _subset_contig_ali(ca: ContigAlignments, mask: np.ndarray
                       ) -> ContigAlignments:
    idx = np.nonzero(mask)[0]
    return ContigAlignments(
        chunk_id=ca.chunk_id[idx], fr=ca.fr[idx], score=ca.score[idx],
        source_start=ca.source_start[idx], source_end=ca.source_end[idx],
        source_gap=ca.source_gap[idx], source_size=ca.source_size[idx],
        target_start=ca.target_start[idx], target_end=ca.target_end[idx],
        target_gap=ca.target_gap[idx],
        pos_map=[ca.pos_map[i] for i in idx])


def _concat_contig_ali(parts: List[ContigAlignments]
                       ) -> ContigAlignments:
    if not parts:
        return ContigAlignments(
            chunk_id=np.zeros(0, np.int32), fr=np.zeros(0, np.int8),
            score=np.zeros(0, np.int32),
            source_start=np.zeros(0, np.int32),
            source_end=np.zeros(0, np.int32),
            source_gap=np.zeros(0, np.int32),
            source_size=np.zeros(0, np.int32),
            target_start=np.zeros(0, np.int32),
            target_end=np.zeros(0, np.int32),
            target_gap=np.zeros(0, np.int32), pos_map=[])
    kw = {f.name: np.concatenate([getattr(p, f.name) for p in parts])
          for f in dataclasses.fields(ContigAlignments)
          if f.name != "pos_map"}
    kw["pos_map"] = [m for p in parts for m in p.pos_map]
    return ContigAlignments(**kw)


def _align_contigs_per_part(genome: Genome, contigs: Contigs,
                            cfg: Config, device) -> ContigAlignments:
    """Per-part contig alignment — the reference's `task1` always aligns
    tmp/_contigs.fa against each tmp/_genome.<i>.fa separately
    (AlignGraph.cpp:3615-3656), so a contig straddling a part cut is
    placed in whichever part(s) pass the C12 coverage filter on the
    part-local alignment.  Coordinates are lifted back to the global
    genome axis afterwards."""
    parts = []
    for p in range(genome.n_parts):
        pseq = np.asarray(genome.part_seq(p), np.int8)
        if len(pseq) < cfg.seed_len:
            continue
        ca = ContigAligner(pseq, cfg, device=device)
        r = ca.align(contigs)
        off = np.int32(genome.part_gstart[p])
        r.target_start += off
        r.target_end += off
        r.pos_map = [np.where(pm >= 0, pm + off, pm) for pm in r.pos_map]
        parts.append(r)
    return _concat_contig_ali(parts)


def _align(cfg: Config, reads: Reads, contigs: Contigs, genome: Genome,
           gseq: np.ndarray, stats: Dict, device
           ) -> Tuple[PairAlignments, ContigAlignments]:
    """Stage (1): the reads' and the contigs' alignments.  The seed index
    and the aligners live in this function only, so the host and the
    device memory they hold is freed when it returns; their host bytes go
    to stats["seed_index_bytes"]."""
    if cfg.iterative_map and genome.n_parts > 1:
        # --iterativeMap: per-part read alignment (reference `task0`
        # per-chromosome branch, AlignGraph.cpp:3581-3613) — bounds
        # index memory at the cost of one pass per part
        parts = []
        for p in range(genome.n_parts):
            pseq = np.asarray(genome.part_seq(p), np.int8)
            if len(pseq) < cfg.seed_len:
                continue
            ra = ReadAligner.build(pseq, cfg, device=device)
            r = ra.align(reads)
            off = int(genome.part_gstart[p])
            r.target_start += np.where(r.target_start >= 0, off, 0)
            r.target_end += np.where(r.target_end >= 0, off, 0)
            r.pos_map += np.where(r.pos_map >= 0, off, 0)
            parts.append(r)
        if parts:
            rali = PairAlignments(**{
                f.name: np.concatenate([getattr(r, f.name) for r in parts])
                for f in dataclasses.fields(PairAlignments)})
        else:
            # every part shorter than the seed length: no read can align
            # anywhere (degenerate input; previously crashed on
            # np.concatenate of an empty list)
            rali = PairAlignments.empty(max(reads.max_len, 1))
        return rali, _align_contigs_per_part(genome, contigs, cfg, device)

    # the reference overlaps read-align and contig-align with a 2-pthread
    # fork (`parallelMap`, AlignGraph.cpp:3720-3735); ours overlaps them
    # with 2 host threads (read batches stream through the device while
    # contig seeding/chaining runs on the host).  One seed index, built on
    # the host, serves both: the contig aligner seeds on it there, the
    # read aligner holds its own copy on the device.
    import concurrent.futures as _cf

    t = time.time()
    index = build_index(gseq, cfg.seed_len)
    stats["seed_index_bytes"] = heap.host_bytes(index)
    r_aligner = ReadAligner.from_index(gseq, index, cfg, device=device)
    # seconds of the index build and of each thread
    threads = stats["alignment_threads"] = {"index": time.time() - t}
    if genome.n_parts == 1:
        c_aligner = ContigAligner(gseq, cfg, index=index, device=device)
        align_c = lambda: c_aligner.align(contigs)  # noqa: E731
    else:
        align_c = lambda: _align_contigs_per_part(  # noqa: E731
            genome, contigs, cfg, device)

    def timed(name, fn):
        t = time.time()
        out = fn()
        threads[name] = time.time() - t
        return out

    with _cf.ThreadPoolExecutor(max_workers=2) as ex:
        fut_r = ex.submit(timed, "reads", lambda: r_aligner.align(reads))
        fut_c = ex.submit(timed, "contigs", align_c)
        return fut_r.result(), fut_c.result()


def _graph_part(cfg: Config, p: int, lo: int, hi: int, genome: Genome,
                contigs: Contigs, reads: Reads, rali: PairAlignments,
                part_rows: np.ndarray,
                cali: ContigAlignments, kstats: KmerBuildStats,
                stage_s: Dict, mem: "_StageMemory", device):
    """Stage (3) for part p: the graph (contig layer, then the k-mer layer
    from the records rali[part_rows]), extension and scaffolding, and the
    part's stage files.  Returns (scaffolds, initial contigs).  The graph,
    the part's placements and what the traversal leaves live in this
    function only, so they are freed before the next part's graph is
    made."""
    mem.begin()
    g = GraphTensors.create(genome.part_seq(p))

    tst = time.time()
    cmask = (cali.target_start >= lo) & (cali.target_start < hi)
    part_cali = _subset_contig_ali(cali, cmask)
    outp = build_contig_layer(g, contigs, part_cali, part_offset=lo)
    initials = initial_contigs(contigs, outp)
    stage_s["contig_layer"] += time.time() - tst
    live = dict(reads=reads, **_record_bytes(rali), cali=cali, graph=g)
    mem.end(f"contig_layer.{p}", **live)
    log.info("  contig layer: %.1fs (%d placements)",
             time.time() - tst, part_cali.n)

    mem.begin()
    tst = time.time()
    phase0 = None
    if cfg.graph_build == "device":
        build_kmer_layer_device(g, rali, reads, cfg.k_mer,
                                cfg.insert_variation, part_offset=lo,
                                stats=kstats, device=device,
                                mark=mem.kmer_mark, rows=part_rows)
        # phase 0's host bytes at most: the [M] bool skip and one chunk's
        # rows (int32 p1, p2 and int8 s1 [c, L]; int32 lens, bool keep)
        M = len(part_rows)
        phase0 = M + min(CHUNK_RECORDS, M) * (9 * rali.pos_map.shape[2] + 5)
    else:
        build_kmer_layer(g, _subset_pairs(rali, part_rows), reads,
                         cfg.k_mer, cfg.insert_variation, part_offset=lo,
                         stats=kstats)
    stage_s["kmer_build"] += time.time() - tst
    mem.end(f"kmer_build.{p}", **live, part_rows=part_rows, phase0=phase0)
    log.info("  kmer build: %.1fs (%d records)",
             time.time() - tst, len(part_rows))

    mem.begin()
    tst = time.time()
    pre_snap: List = []
    scaffolds, _pre = extend_and_scaffold(g, cfg.coverage, cfg.k_mer,
                                          pre_snapshot=pre_snap)
    stage_s["traverse"] += time.time() - tst
    mem.end(f"traverse.{p}", **live)
    log.info("  traverse+scaffold: %.1fs", time.time() - tst)
    _write_stage_files(cfg.work_dir, p, initials, pre_snap, scaffolds)
    return scaffolds, initials


def _trim(stats: Dict) -> None:
    """utils/heap.trim between stages; its seconds add up in
    stats["heap_trim_seconds"]."""
    t = time.time()
    heap.trim()
    stats["heap_trim_seconds"] = stats.get("heap_trim_seconds", 0.0) + \
        time.time() - t


class _StageMemory:
    """stats["memory"][stage] = {"host_max_rss_bytes": the process's peak
    RSS when the stage ended, "host_rss_bytes": its RSS then,
    "host_heap_bytes": the bytes malloc then holds for live allocations
    (None without mallinfo2), "arrays": {name: bytes} of the large host
    objects still bound then (utils/heap.host_bytes; an int is taken as
    bytes), and on a CUDA device "device_peak_bytes": the peak allocated
    bytes during the stage (the peak is reset when it begins),
    "device_allocated_bytes": the bytes allocated at its end}; and
    stats["kmer_state_bytes"], per part built on a CUDA device, the bytes
    allocated between the k-mer build's start and the end of its first
    "h2d" stage: the state and the anchor pack."""

    def __init__(self, device, stats: Dict):
        self.cuda = torch.device(device).type == "cuda"
        self.out = stats.setdefault("memory", {})
        self.state = stats.setdefault("kmer_state_bytes", [])
        self.base = None

    def begin(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()

    def end(self, stage: str, **live) -> None:
        rec = {"host_max_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
            "host_rss_bytes": heap.rss_bytes(),
            "host_heap_bytes": heap.heap_in_use_bytes(),
            "arrays": {k: v if isinstance(v, int) else heap.host_bytes(v)
                       for k, v in live.items() if v is not None}}
        if self.cuda:
            torch.cuda.synchronize()
            rec["device_peak_bytes"] = torch.cuda.max_memory_allocated()
            rec["device_allocated_bytes"] = torch.cuda.memory_allocated()
        self.out[stage] = rec

    def kmer_mark(self, name: str) -> None:
        """build_kmer_layer_device's `mark`, after begin()."""
        if self.cuda and name == "h2d" and self.base is not None:
            self.state.append(torch.cuda.memory_allocated() - self.base)
            self.base = None


def graph_build_for(device, k_mer: int) -> str:
    """The k-mer layer build that the port's entry points run on `device`:
    "device" on a CUDA device when k_mer <= MAX_K (the device build packs
    a k-mer 3 bits a base into an int32 key), else "host".  Both builds
    write the same graph bit for bit.  Config's default, "host", is the
    JAX package's, chosen for a TPU behind a slow link (config.py); on a
    CUDA card the device build is the faster one."""
    if torch.device(device).type == "cuda" and k_mer <= MAX_K:
        return "device"
    return "host"


def check_ratio(rali: PairAlignments, n_pairs: int) -> float:
    """C25 (`checkRatio`, AlignGraph.cpp:3751-3819): fraction of pairs
    passing the C13 filters; warns below 25%."""
    if n_pairs == 0:
        return 0.0
    ok = rali.ratio_ok(THRESHOLD)
    frac = len(np.unique(rali.pair_id[ok])) / n_pairs
    if frac < 0.25:
        log.warning("ratio check: only %.1f%% of read pairs aligned — "
                    "results may be poor (reference warns at <25%%)",
                    frac * 100)
    return frac


def run_pipeline(cfg: Config,
                 reads: Optional[Reads] = None,
                 contigs: Optional[Contigs] = None,
                 genome: Optional[Genome] = None,
                 checkpoint=None, *, device,
                 auto_graph_build: bool = False) -> PipelineResult:
    """The whole reassembly; the aligners, and the k-mer layer build when
    cfg.graph_build is "device", run on `device` ("cuda" launches the
    hand-written kernels, "cpu" runs their plain versions).

    auto_graph_build: cfg.graph_build is replaced by graph_build_for(
    device, cfg.k_mer), after --resume has reloaded the command (which
    does not carry graph_build).  The build that ran goes to
    stats["graph_build"], the seconds of stage (0) to
    stats["formalize_seconds"].

    Memory per stage goes to stats["memory"] (_StageMemory): on a CUDA
    device each stage resets torch.cuda's peak memory statistics."""
    t0 = time.time()
    stats: Dict = {}
    mem = _StageMemory(device, stats)

    # --resume: restore config from the work dir's command round-trip and
    # pick up from the last checkpoint (reference :4748-4760)
    resume_from = -1
    if cfg.resume:
        from aligngraph_tpu_torch.pipeline.checkpoint import Checkpoint
        checkpoint = Checkpoint(cfg.work_dir)
        cfg = checkpoint.load_command()
        resume_from = checkpoint.get()
        log.info("resuming from checkpoint %d", resume_from)
    elif checkpoint is not None:
        checkpoint.save_command(cfg)
    if auto_graph_build:
        cfg = dataclasses.replace(
            cfg, graph_build=graph_build_for(device, cfg.k_mer))
        log.info("k-mer layer build: %s (device %s, k %d; the device "
                 "build takes k <= %d)", cfg.graph_build, device,
                 cfg.k_mer, MAX_K)
    stats["graph_build"] = cfg.graph_build

    stage_banner(0, "formalizing inputs")
    tf = time.time()
    if reads is None:
        # bounded resident read memory (C14, AlignGraph.cpp:37, 361-404):
        # large inputs go to a disk-backed memmap filled streamingly; the
        # aligner consumes fixed batch_pairs slices of it
        mm = None
        try:
            insize = os.path.getsize(cfg.read1) + os.path.getsize(cfg.read2)
        except OSError:
            insize = 0
        if cfg.stream_reads or insize > cfg.stream_reads_threshold:
            os.makedirs(cfg.work_dir, exist_ok=True)
            mm = os.path.join(cfg.work_dir, "_reads.npy")
        reads = formalize_reads(cfg.read1, cfg.read2, memmap_path=mm)
    if contigs is None:
        contigs = formalize_contigs(cfg.contig)
    if genome is None:
        genome = formalize_genome(cfg.genome, cfg.part)
    cfg.validate(max_read_length=reads.max_read_length or None)
    stats["formalize_seconds"] = time.time() - tf
    stats["n_pairs"] = reads.n_pairs
    stats["n_contigs"] = contigs.n_real
    stats["n_parts"] = genome.n_parts

    mem.begin()
    ta = time.time()
    gseq = np.asarray(genome.seq, np.int8)
    restored = None
    if resume_from >= 0 and checkpoint is not None:
        restored = checkpoint.load_alignments()
    if restored is not None:
        stage_banner(1, "alignment restored from checkpoint")
        rali, cali = restored
    else:
        stage_banner(1, "aligning reads and contigs (in-engine)")
        rali, cali = _align(cfg, reads, contigs, genome, gseq, stats,
                            device)
        if checkpoint is not None:
            checkpoint.save_alignments(rali, cali)
            checkpoint.set(0)
    del restored
    # the seed index and the aligners were _align's and are gone: hand
    # the heap pages of their host arrays and temporaries back before
    # the parts' graphs are made
    _trim(stats)
    align_seconds = time.time() - ta
    mem.end("alignment", reads=reads, **_record_bytes(rali), cali=cali)
    stats["read_alignments"] = rali.n
    stats["contig_placements"] = cali.n

    if cfg.ratio_check:
        stage_banner(2, "ratio check")
        stats["aligned_pair_fraction"] = check_ratio(rali, reads.n_pairs)

    # C13 filter (the graph loader's acceptance test), kept as the
    # indices of the accepted records: the records' pos_map is not copied
    accepted = np.flatnonzero(rali.ratio_ok(THRESHOLD))
    part_bounds = np.concatenate(
        [genome.part_gstart, [genome.total_len]]).astype(np.int64)

    per_part_scaffolds: List[List[np.ndarray]] = []
    per_part_initials: List[List[Tuple[int, np.ndarray]]] = []
    kstats = KmerBuildStats()
    stage_s = {"contig_layer": 0.0, "kmer_build": 0.0, "traverse": 0.0}
    stats["stage_seconds"] = stage_s
    # the traversal takes the C++ walk when its library loads, else the
    # Python one (graph/traverse.extd_contigs1_dispatch)
    stats["native_traversal"] = native.get_lib() is not None
    for p in range(genome.n_parts):
        if checkpoint is not None and resume_from >= p + 1:
            saved = checkpoint.load_part(p)
            if saved is not None:
                scaffolds, initials = saved
                per_part_scaffolds.append(scaffolds)
                per_part_initials.append(initials)
                continue
        stage_banner(3, f"graph build + extension: part {p + 1}/"
                        f"{genome.n_parts}")
        lo, hi = int(part_bounds[p]), int(part_bounds[p + 1])
        ts = rali.target_start[accepted]
        part_rows = accepted[(ts[:, 0] >= lo) & (ts[:, 0] < hi)
                             & (ts[:, 1] >= lo) & (ts[:, 1] < hi)]
        del ts
        scaffolds, initials = _graph_part(
            cfg, p, lo, hi, genome, contigs, reads, rali, part_rows, cali,
            kstats, stage_s, mem, device)
        per_part_scaffolds.append(scaffolds)
        per_part_initials.append(initials)
        # the part's graph and its k-mer build's temporaries are gone
        _trim(stats)
        log_memory(f"part {p + 1}")   # reference: ps euf >> mem.txt
        if checkpoint is not None:
            checkpoint.save_part(p, scaffolds, initials)
            checkpoint.set(p + 1)
    stats["kmer_build"] = dataclasses.asdict(kstats)
    stats["n_scaffolds"] = sum(len(s) for s in per_part_scaffolds)
    # refinement and misassembly removal align the contigs anew: the
    # records and the placements are not needed past the parts
    del rali, cali, accepted

    stage_banner(4, "refinement")
    mem.begin()
    tst = time.time()
    res = refine(cfg, genome, contigs, per_part_initials,
                 per_part_scaffolds, device=device)
    stage_s["refinement"] = time.time() - tst
    mem.end("refinement", reads=reads)
    stage_s["alignment"] = align_seconds

    out = PipelineResult(
        extended_ids=res.extended_ids, extended_seqs=res.extended_seqs,
        remaining_ids=res.remaining_ids + contigs.chaff_ids,
        remaining_seqs=res.remaining_seqs + [
            np.frombuffer(s, np.uint8).astype(np.int8)
            for s in contigs.chaff_seqs],
        per_part_scaffolds=per_part_scaffolds,
        per_part_initials=per_part_initials,
        stats=stats,
        wall_seconds=time.time() - t0,
        align_seconds=align_seconds,
    )

    if cfg.extended_contig:
        _write_out(cfg.extended_contig, out.extended_ids, out.extended_seqs)
    if cfg.remaining_contig:
        _write_remaining(cfg.remaining_contig, res, contigs)

    # (5) optional misassembly removal over both outputs (C26,
    # AlignGraph.cpp:4789-4790) -> corrected_<file>
    if cfg.misassembly_removal and cfg.extended_contig \
            and cfg.remaining_contig:
        from aligngraph_tpu_torch.pipeline.misassembly import \
            remove_misassembly
        stage_banner(5, "misassembly removal")
        remove_misassembly(cfg.extended_contig, cfg, gseq, reads,
                           which="extended", device=device)
        remove_misassembly(cfg.remaining_contig, cfg, gseq, reads,
                           which="remaining",
                           chaff=(contigs.chaff_ids, contigs.chaff_seqs),
                           device=device)

    log.info("FINISHED in %.1fs (alignment %.1fs)", out.wall_seconds,
             align_seconds)
    return out


def _wrap60(f, seq) -> None:
    """Reference FASTA body wrapping: newline every 60 bases and after
    the final base (AlignGraph.cpp:1209-1213 and equivalents)."""
    s = decode(np.asarray(seq, np.int8))
    if isinstance(s, bytes):
        s = s.decode()
    for i in range(0, len(s), 60):
        f.write(s[i:i + 60] + "\n")


def _write_stage_files(work_dir: str, p: int, initials, pre,
                       scaffolds) -> None:
    """Per-part tmp/ stage artifacts in the reference binary's exact
    formats, so scale-parity breaks can be bisected stage by stage
    (test_golden_parity.test_intermediate_stage_files):

    _initial_contigs.<p>.fa      C17 output, '>cp' = real-contig group
                                 index (AlignGraph.cpp:1179-1216)
    _pre_extended_contigs.<p>.fa C21 output, header '>seqID, extended,
                                 startID, startOffset, endID, endOffset,
                                 startID0, startOffset0, endID0,
                                 endOffset0 ' with unsigned-int printing
                                 and a trailing space (:2178)
    _extended_contigs.<p>.fa     C23 output, '>seqID' (:2450-2460)
    """
    os.makedirs(work_dir, exist_ok=True)

    def u(x) -> int:
        return int(x) & 0xFFFFFFFF

    with open(os.path.join(work_dir, f"_initial_contigs.{p}.fa"),
              "w") as f:
        for r, seq in initials:
            f.write(f">{int(r)}\n")
            _wrap60(f, seq)
    with open(os.path.join(work_dir, f"_pre_extended_contigs.{p}.fa"),
              "w") as f:
        for i, c in enumerate(pre):
            f.write(f">{i}, {int(c.extended)}, {u(c.start_id)}, "
                    f"{u(c.start_off)}, {u(c.end_id)}, {u(c.end_off)}, "
                    f"{u(c.start0_id)}, {u(c.start0_off)}, "
                    f"{u(c.end0_id)}, {u(c.end0_off)} \n")
            _wrap60(f, np.frombuffer(bytes(c.seq), np.int8))
    with open(os.path.join(work_dir, f"_extended_contigs.{p}.fa"),
              "w") as f:
        for i, s in enumerate(scaffolds):
            f.write(f">{i}\n")
            _wrap60(f, s)


def _write_out(path: str, ids: List[str], seqs: List[np.ndarray]) -> None:
    write_fasta(path, ids, [decode(s) for s in seqs])


def _write_remaining(path: str, res: RefinementResult,
                     contigs: Contigs) -> None:
    """Remaining = untagged initial contigs + chaff verbatim
    (AlignGraph.cpp:3135-3167)."""
    with open(path, "wb") as f:
        write_fasta(f, res.remaining_ids,
                    [decode(s) for s in res.remaining_seqs])
        write_fasta(f, contigs.chaff_ids, contigs.chaff_seqs)
