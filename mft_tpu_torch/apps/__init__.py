"""Applications of the port: the tracking demo and the pairwise-flow demo."""
