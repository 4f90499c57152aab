from aligngraph_tpu_torch.io.fasta import (  # noqa: F401
    read_fasta, write_fasta, encode, decode, revcomp, complement_code,
)
from aligngraph_tpu_torch.io.formalize import (  # noqa: F401
    Reads, Contigs, Genome,
    formalize_reads, formalize_contigs, formalize_genome,
)
