"""The ML-guided scheduler (paper §4.4), port of ``repro.ml``: the
scoring basis, k-means, the random forest and the fitted pipeline. ES
training of the scoring weights is not ported yet (``train`` holds only
the checkpoint reader)."""
