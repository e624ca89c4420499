"""Plain reference of the three calls the benchmark drives, written from the
algorithms (GATK's PairHMM and PDHMM forward DPs in float64, the affine-gap
Smith-Waterman with its overhang strategies) in PyTorch and NumPy, plus a
plain BGZF/BAM writer.  Nothing here imports the program under test."""
