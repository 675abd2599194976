"""Paired-end seed-and-extend alignment on the device.

  index.kmer.find_seeds_hash — hash k-mer seeding
  chain.chain_seeds_nms      — sort-free seed chaining
  ops.seed_chain             — both in one CUDA kernel (the two above are
                               its plain twin)
  sw                         — banded Smith-Waterman (CUDA kernels)
  core                       — pair selection, extension, mate rescue, XA
  markdup / emit             — SAMBLASTER-equivalent epilogue
  pipeline                   — FASTQ → BAM triple driver (speedseq align)
  realign                    — BAM(s) → BAM triple (speedseq realign)
"""
