"""The ML-guided scheduler (paper §4.4), port of ``repro.ml``: the
scoring basis, k-means, the random forest, the fitted pipeline, and ES
training of the scoring weights over batched twin rollouts
(``train``)."""
