"""The plain reference of the tiled Gaussian ray tracer: binning,
compositing, an L1 loss's gradient by autograd and Adam, in plain
PyTorch.  It imports nothing of the program and takes nothing the program
made: it works out its own matrices, rays, rows, lists and updates from
the benchmark's inputs."""
