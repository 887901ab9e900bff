"""One module per model family, found by the `family` of a configuration:
how to make its weights and batches from the seed, how to build the
port's training step on them, the plain reference's loss, and the model
FLOPs and kernel calls of a step, counted from the shapes."""
