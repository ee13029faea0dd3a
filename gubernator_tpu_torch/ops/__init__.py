"""Device-side state layout and the kernels of the decision step."""
