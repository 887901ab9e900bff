"""Plain float32 PyTorch references of the benchmark's models. They import
nothing of the port: the benchmark hands them the weights and batches it
made itself, and compares what the port's timed step produced with what
they compute."""
