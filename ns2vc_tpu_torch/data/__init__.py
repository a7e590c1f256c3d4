"""Training data: feature datasets, fixed-shape collation, the batch loader
and the offline preprocess driver."""
