"""The port's ContigAligner.align on the CPU against the JAX
ContigAligner.align: every ContigAlignments field and every pos_map equal
(tolerance 0, all integer)."""

import dataclasses

import numpy as np
import pytest
import torch

from aligngraph_tpu.align.contig_aligner import ContigAligner as JaxAligner
from aligngraph_tpu.align.types import ContigAlignments
from aligngraph_tpu.config import Config
from aligngraph_tpu_torch.align.contig_aligner import DP_BATCH, ContigAligner
from aligngraph_tpu_torch.ops.seeding import build_index
from tests.simdata import make_simdata, revcomp_np
from tests.test_contig_aligner import contigs_from_arrays


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_contig_alignments_equal(got: ContigAlignments,
                                   want: ContigAlignments, min_rows=0):
    assert got.n == want.n and got.n >= min_rows
    for f in dataclasses.fields(ContigAlignments):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "pos_map":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def _basic():
    sim = make_simdata(seed=5, genome_len=40_000, n_pairs=1, n_contigs=8,
                       snp_rate=0.01)
    return sim.reference, sim.contigs


def _revcomp():
    sim = make_simdata(seed=6, genome_len=20_000, n_pairs=1, n_contigs=4,
                       snp_rate=0.005)
    return sim.reference, [revcomp_np(s) for s in sim.contigs]


def _exact():
    g = np.random.default_rng(0).integers(0, 4, 10_000).astype(np.int8)
    return g, [g[2000:5000].copy()]


def _large_deletion():
    target = np.random.default_rng(1).integers(0, 4, 30_000).astype(np.int8)
    reference = np.concatenate([target[:12_000], target[17_000:]])
    return reference, [target[9_000:20_000].copy()]


def _below_size():
    g = np.random.default_rng(2).integers(0, 4, 5000).astype(np.int8)
    return g, [g[100:290].copy()]


# the five cases of tests/test_contig_aligner.py: (inputs, least rows)
CASES = {"basic": (_basic, 7), "revcomp": (_revcomp, 3),
         "exact_positions": (_exact, 1),
         "large_deletion_chained": (_large_deletion, 1),
         "below_size_filter": (_below_size, 0)}


@pytest.mark.parametrize("fast_map", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_contig_aligner_equals_jax(case, fast_map):
    make, least = CASES[case]
    genome, seqs = make()
    contigs = contigs_from_arrays(seqs)
    cfg = Config(fast_map=fast_map)
    want = JaxAligner(genome, cfg).align(contigs)
    got = ContigAligner(genome, cfg, device="cpu").align(contigs)
    assert_contig_alignments_equal(got, want, 0 if fast_map else least)


def test_shared_index_equals_jax_and_is_not_copied():
    """run_pipeline's sharing: the read aligner's index, already on the
    aligner's device, serves the contig aligner as it is: its tensors are
    the ones passed in, no copy and no host view kept."""
    genome, seqs = _large_deletion()
    contigs = contigs_from_arrays(seqs)
    cfg = Config()
    jax_al = JaxAligner(genome, cfg)
    index = build_index(genome, cfg.seed_len, device="cpu")
    al = ContigAligner(genome, cfg, index=index, device="cpu")
    assert al.index is index
    for f in ("sorted_kmers", "sorted_posflip", "bucket_lo"):
        assert getattr(al.index, f) is getattr(index, f)
    assert not {"_sorted_kmers", "_sorted_posflip"} & set(vars(al))
    np.testing.assert_array_equal(al.index.sorted_kmers.numpy(),
                                  jax_al.index.sorted_kmers_np)
    assert_contig_alignments_equal(al.align(contigs),
                                   jax_al.align(contigs), 1)


@pytest.mark.parametrize("dp_batch", [16, DP_BATCH["cuda"]])
def test_dp_batch_does_not_change_output(dp_batch):
    """Lanes are independent and padding lanes have tlen 0: batches of 16
    (many batches, a partial tail) and of the CUDA size 2048 give the CPU
    batch's (512) output, which equals JAX's."""
    genome, seqs = _basic()
    contigs = contigs_from_arrays(seqs)
    cfg = Config()
    al = ContigAligner(genome, cfg, device="cpu")
    assert al.dp_batch == DP_BATCH["cpu"] == 512
    base = al.align(contigs)
    al.dp_batch = dp_batch
    assert_contig_alignments_equal(al.align(contigs), base, 7)
    assert_contig_alignments_equal(base, JaxAligner(genome, cfg).align(
        contigs), 7)


def test_rejects_device_index_and_unknown_device(monkeypatch):
    """An index on a device other than the aligner's raises, a CPU index
    is moved to the aligner's device once, an unknown device raises."""
    genome, _ = _exact()
    cfg = Config()
    index = build_index(genome, 13, device="cpu")
    with pytest.raises(ValueError, match="seed index on meta"):
        ContigAligner(genome, cfg, index=index.to("meta"), device="cpu")
    # a device with a contig-aligner path other than the index's: "meta"
    # stands in for the card
    monkeypatch.setitem(DP_BATCH, "meta", DP_BATCH["cuda"])
    al = ContigAligner(genome, cfg, index=index, device="meta")
    for f in ("sorted_kmers", "sorted_posflip", "bucket_lo"):
        moved = getattr(al.index, f)
        assert moved.device.type == "meta"
        assert moved.shape == getattr(index, f).shape
    assert index.sorted_kmers.device.type == "cpu"
    monkeypatch.delitem(DP_BATCH, "meta")
    with pytest.raises(ValueError, match="no contig-aligner path"):
        ContigAligner(genome, cfg, device="meta")
