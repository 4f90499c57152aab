"""The port's own copies of the JAX package's host modules (config, io,
align/types, graph/{model, contig_layer, kmer_layer, traverse}, native,
pipeline/checkpoint, compat/textout, utils) against their originals on
seeded cases, and the port's independence from the JAX package.

Each side gets its inputs built with its own package from the same numpy
arrays or FASTA files (a dataclass of one package never equals one of the
other), and the outputs are compared field by field (tolerance 0)."""

import copy
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from aligngraph_tpu import native as j_native
from aligngraph_tpu.align import types as j_types
from aligngraph_tpu.compat import textout as j_textout
from aligngraph_tpu.config import Config as JConfig
from aligngraph_tpu.config import ConfigError as JConfigError
from aligngraph_tpu.graph import contig_layer as j_cl
from aligngraph_tpu.graph import kmer_layer as j_kl
from aligngraph_tpu.graph import traverse as j_tr
from aligngraph_tpu.graph.model import GraphTensors as JGraph
from aligngraph_tpu.io import fasta as j_fasta
from aligngraph_tpu.io import formalize as j_form
from aligngraph_tpu.pipeline.checkpoint import Checkpoint as JCheckpoint
from aligngraph_tpu.utils import hostmem as j_hostmem
from aligngraph_tpu_torch import native as t_native
from aligngraph_tpu_torch.align import types as t_types
from aligngraph_tpu_torch.compat import textout as t_textout
from aligngraph_tpu_torch.config import Config as TConfig
from aligngraph_tpu_torch.config import ConfigError as TConfigError
from aligngraph_tpu_torch.graph import contig_layer as t_cl
from aligngraph_tpu_torch.graph import kmer_layer as t_kl
from aligngraph_tpu_torch.graph import traverse as t_tr
from aligngraph_tpu_torch.graph.model import GraphTensors as TGraph
from aligngraph_tpu_torch.io import fasta as t_fasta
from aligngraph_tpu_torch.io import formalize as t_form
from aligngraph_tpu_torch.pipeline.checkpoint import Checkpoint as TCheckpoint
from aligngraph_tpu_torch.utils import hostmem as t_hostmem
from tests.simdata import make_simdata
from tests.test_graph import align_all

REPO = Path(__file__).resolve().parent.parent


def assert_same(got, want, path="value"):
    """Equal field by field across the two packages' classes: dataclasses
    by their fields (the class names must match), arrays by dtype and
    value, containers item by item."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        assert type(got) is not type(want), f"{path}: same class"
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def port_copy(obj, module):
    """The same data as an instance of the port's class of that name."""
    cls = getattr(module, type(obj).__name__)
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def sim_case(tmp_path_factory):
    """tests/test_native.py's sim as FASTA files, aligned by the JAX
    aligners (both packages take the same records)."""
    sim = make_simdata(seed=21, genome_len=15_000, n_pairs=1200,
                       read_len=90, insert=450, snp_rate=0.008,
                       err_rate=0.003, n_contigs=5)
    cfg = JConfig(distance_low=150, distance_high=750, coverage=4)
    contigs, reads, cali, rali = align_all(sim, cfg)
    d = tmp_path_factory.mktemp("host_copies")
    n = len(sim.reads1)
    j_fasta.write_fasta(d / "genome.fa", ["chrA"],
                        [j_fasta.decode(sim.reference)])
    j_fasta.write_fasta(d / "contigs.fa", [f"ctg{i}" for i in
                                           range(len(sim.contigs))],
                        [j_fasta.decode(c) for c in sim.contigs])
    for mate, seqs in (("r1", sim.reads1), ("r2", sim.reads2)):
        j_fasta.write_fasta(d / f"{mate}.fa", [f"p{i}" for i in range(n)],
                            [j_fasta.decode(r) for r in seqs])
    return dict(sim=sim, cfg=cfg, contigs=contigs, reads=reads, cali=cali,
                rali=rali, dir=d)


def graphs(case, kmer: bool):
    """Each package's GraphTensors after its contig layer (and, with
    `kmer`, its host k-mer layer) -> (jax graph, port graph, jax outputted,
    port outputted, jax stats, port stats)."""
    sim, cfg = case["sim"], case["cfg"]
    gj, gt = JGraph.create(sim.reference), TGraph.create(sim.reference)
    oj = j_cl.build_contig_layer(gj, case["contigs"], case["cali"])
    ot = t_cl.build_contig_layer(gt, port_copy(case["contigs"], t_form),
                                 port_copy(case["cali"], t_types))
    sj = st = None
    if kmer:
        sj = j_kl.build_kmer_layer(gj, case["rali"], case["reads"],
                                   cfg.k_mer, cfg.insert_variation,
                                   chunk_records=512)
        st = t_kl.build_kmer_layer(gt, port_copy(case["rali"], t_types),
                                   port_copy(case["reads"], t_form),
                                   cfg.k_mer, cfg.insert_variation,
                                   chunk_records=512)
    return gj, gt, oj, ot, sj, st


ARGV = [
    ["--read1", "r1.fa", "--read2", "r2.fa", "--contig", "c.fa", "--genome",
     "g.fa", "--distanceLow", "300", "--distanceHigh", "700",
     "--extendedContig", "e.fa", "--remainingContig", "rm.fa", "--kMer",
     "5", "--coverage", "10", "--fastMap"],
    ["--read1", "a", "--read2", "b", "--contig", "c", "--genome", "d",
     "--distanceLow", "100", "--distanceHigh", "900", "--extendedContig",
     "e", "--remainingContig", "f", "--part", "3", "--iterativeMap",
     "--misassemblyRemoval", "--ratioCheck", "--insertVariation", "40"],
    ["--resume"],
]
BAD_ARGV = [["--kMer", "5", "--kMer", "6"], ["--resume", "--kMer", "5"],
            ["--kMr", "5"], ["--part", "03"], ["--kMer"]]


def case_config(case, tmp):
    for argv in ARGV:
        cj, ct = JConfig.from_argv(argv), TConfig.from_argv(argv)
        assert_same(ct, cj)
        assert ct.to_argv() == cj.to_argv()
        if not cj.resume:      # to_argv does not carry --resume
            assert_same(TConfig.from_argv(ct.to_argv()), cj)
    for argv in BAD_ARGV:
        with pytest.raises(JConfigError) as ej:
            JConfig.from_argv(argv)
        with pytest.raises(TConfigError) as et:
            TConfig.from_argv(argv)
        assert str(et.value) == str(ej.value), argv
    for kw in (dict(part=11), dict(distance_low=10, distance_high=5),
               dict(part=5)):
        full = dict(read1="a", read2="b", contig="c", genome="d",
                    extended_contig="e", remaining_contig="f", **kw)
        outcome = []
        for cls, err in ((JConfig, JConfigError), (TConfig, TConfigError)):
            try:
                cls(**full).validate(max_read_length=100)
                outcome.append("ok")
            except err as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], kw
    cfg = dict(read1="r1", read2="r2", contig="c", genome="g",
               extended_contig="e", remaining_contig="r", distance_low=100,
               distance_high=900, iterative_map=True)
    JConfig(**cfg).save_command(str(tmp / "j.txt"))
    TConfig(**cfg).save_command(str(tmp / "t.txt"))
    assert (tmp / "j.txt").read_bytes() == (tmp / "t.txt").read_bytes()
    assert_same(TConfig.load_command(str(tmp / "j.txt")),
                JConfig.load_command(str(tmp / "t.txt")))


def case_fasta(case, tmp):
    data = (b">rec one extra words\r\nACGTacgt\nNNN\n\n"
            b">rec2\nTTTTxy\n>empty\n>last\nGG\n")
    p = tmp / "t.fa"
    p.write_bytes(data)
    # the stream path (Python) and the file path (the C++ parser)
    assert_same(t_fasta.read_fasta(io.BytesIO(data)),
                j_fasta.read_fasta(io.BytesIO(data)))
    assert_same(t_fasta.read_fasta(str(p)), j_fasta.read_fasta(str(p)))
    assert_same(t_native.read_fasta_native(str(p)),
                j_native.read_fasta_native(str(p)))
    codes = j_fasta.encode(b"ACGTNacgtnXY" * 7)
    assert_same(t_fasta.encode(b"ACGTNacgtnXY" * 7), codes)
    assert t_fasta.decode(codes) == j_fasta.decode(codes)
    assert_same(t_fasta.revcomp(codes), j_fasta.revcomp(codes))
    seqs = [codes, b"ACGT" * 40]
    assert t_fasta.fasta_bytes(["a", "b"], seqs) == \
        j_fasta.fasta_bytes(["a", "b"], seqs)


def case_formalize(case, tmp):
    d = case["dir"]
    assert_same(t_form.formalize_reads(d / "r1.fa", d / "r2.fa"),
                j_form.formalize_reads(d / "r1.fa", d / "r2.fa"))
    assert_same(t_form.formalize_contigs(d / "contigs.fa"),
                j_form.formalize_contigs(d / "contigs.fa"))
    for part in (1, 3):
        assert_same(t_form.formalize_genome(d / "genome.fa", part),
                    j_form.formalize_genome(d / "genome.fa", part))
    j_fasta.write_fasta(tmp / "short.fa", ["p0"], [b"ACGT"])
    for form in (j_form, t_form):
        with pytest.raises(form.FormalizeError,
                           match="INCONSISTENT PE FILES"):
            form.formalize_reads(d / "r1.fa", tmp / "short.fa")


def case_contig_layer(case, tmp):
    gj, gt, oj, ot, _, _ = graphs(case, kmer=False)
    assert_same(gt, gj)
    assert_same(ot, oj)
    assert int(gt.cm_cnt.sum()) > 1000
    assert_same(t_cl.initial_contigs(port_copy(case["contigs"], t_form), ot),
                j_cl.initial_contigs(case["contigs"], oj))


def case_kmer_layer(case, tmp):
    gj, gt, _, _, sj, st = graphs(case, kmer=True)
    assert_same(gt, gj)
    assert_same(st, sj)
    assert st.tuples > 10_000


def walk_case(case, native: bool):
    gj, gt, _, _, _, _ = graphs(case, kmer=True)
    cov, k = case["cfg"].coverage, case["cfg"].k_mer
    pj, pt = [], []
    sj = j_tr.extend_and_scaffold(gj, cov, k, force_python=not native,
                                  pre_snapshot=pj)
    st = t_tr.extend_and_scaffold(gt, cov, k, force_python=not native,
                                  pre_snapshot=pt)
    assert_same(st, sj)
    assert_same(pt, pj)
    assert_same(gt, gj)
    assert len(st[0]) >= 1 and len(pt) >= 1


def case_traverse_python(case, tmp):
    walk_case(case, native=False)


def case_traverse_native(case, tmp):
    assert t_native.get_lib() is not None
    walk_case(case, native=True)
    # the C++ walk alone, on the same graph
    gj, gt, _, _, _, _ = graphs(case, kmer=True)
    cov, k = case["cfg"].coverage, case["cfg"].k_mer
    assert_same(t_native.extd_contigs1_native(gt, cov, k),
                j_native.extd_contigs1_native(gj, cov, k))
    assert_same(gt, gj)


def case_native_build_dir(case, tmp):
    """The port builds its C++ libraries into its git-ignored _build/,
    never next to its sources."""
    src = REPO / "aligngraph_tpu_torch" / "native"
    assert t_native.get_lib() is not None
    assert t_native.get_fasta_lib() is not None
    assert not list(src.glob("*.so"))
    built = REPO / "aligngraph_tpu_torch" / "_build"
    assert (built / "libagtraverse.so").exists()
    assert (built / "libagfasta.so").exists()


def rec_table(case):
    sim = case["sim"]
    return ["chrA"], np.array([0], np.int64), np.array([len(sim.reference)])


def case_textout_sam(case, tmp):
    ids, starts, _ = rec_table(case)
    rali = case["rali"]
    want = j_textout.sam_lines(rali, case["reads"].n_pairs, ids, starts)
    got = t_textout.sam_lines(port_copy(rali, t_types),
                              case["reads"].n_pairs, ids, starts)
    assert got == want and len(got) > 2000


def case_textout_psl(case, tmp):
    ids, starts, lens = rec_table(case)
    cali = case["cali"]
    chunk_ids = [f"ctg{int(c)}" for c in cali.chunk_id]
    want = j_textout.psl_lines(cali, chunk_ids, ids, starts, lens)
    got = t_textout.psl_lines(port_copy(cali, t_types), chunk_ids, ids,
                              starts, lens)
    assert got == want and len(got) >= 3


def case_textout_delta(case, tmp):
    ids, starts, lens = rec_table(case)
    cali = case["cali"]
    chunk_ids = [f"ctg{int(c)}" for c in cali.chunk_id]
    sizes = [int(s) for s in cali.source_size]
    want = j_textout.delta_lines(cali, chunk_ids, sizes, ids, starts, lens)
    got = t_textout.delta_lines(port_copy(cali, t_types), chunk_ids, sizes,
                                ids, starts, lens)
    assert got == want and len(got) >= 6


def case_checkpoint(case, tmp):
    """A round trip through each package's Checkpoint writes the same
    command and stage files, and gives back the same alignments and parts
    as the port's own classes."""
    cfg = dict(read1="r1", read2="r2", contig="c", genome="g",
               extended_contig="e", remaining_contig="r", distance_low=150,
               distance_high=750)
    rali, cali = case["rali"], case["cali"]
    scaffolds = [case["sim"].contigs[0], case["sim"].contigs[1][:500]]
    initials = [(0, 1), (2, 3)]
    out = {}
    for name, ck, conf, types in (("j", JCheckpoint, JConfig, j_types),
                                  ("t", TCheckpoint, TConfig, t_types)):
        c = ck(str(tmp / name))
        assert c.get() == -1 and c.load_alignments() is None
        c.save_command(conf(**cfg))
        c.set(0)
        c.save_alignments(port_copy(rali, types), port_copy(cali, types))
        c.save_part(0, scaffolds, initials)
        c.set(1)
        out[name] = (c.load_command(), c.get(), c.load_alignments(),
                     c.load_part(0), c.load_part(1))
    for f in ("_command.txt", "_checkpoint.txt"):
        assert (tmp / "t" / f).read_bytes() == (tmp / "j" / f).read_bytes()
    assert_same(out["t"], out["j"])
    assert isinstance(out["t"][2][0], t_types.PairAlignments)
    assert isinstance(out["t"][2][1], t_types.ContigAlignments)


def case_hostmem(case, tmp):
    assert t_hostmem.tune_host_malloc() == j_hostmem.tune_host_malloc()


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_equals_original(name, sim_case, tmp_path):
    CASES[name](sim_case, tmp_path)


IMPORT_ALL = """
import importlib, pkgutil, sys
import aligngraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    aligngraph_tpu_torch.__path__, "aligngraph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "aligngraph_tpu" or m.startswith("aligngraph_tpu."))
assert not bad, bad
print(len(names), "modules")
"""


def test_port_imports_load_no_jax_package():
    """With JAX installed, importing every module of the port and
    chip_smoke.py loads neither jax nor any module of aligngraph_tpu."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 40, proc.stdout
