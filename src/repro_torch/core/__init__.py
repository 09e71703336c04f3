"""Paper math and the sketch pipeline: schemes, packing, the threefry
generator behind the canonical R, collision probabilities, estimators."""
