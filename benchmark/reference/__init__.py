"""The plain reference: MFCC, the BadNets patch, SmallCNN's train and eval
steps with Adam, FlowMur's trigger-search step, and the global batch's step
that the four-card cell's sharded step is held to. Plain PyTorch and NumPy,
written from the published formulas; it imports nothing of the port and
nothing of JAX, and works out again whatever the port derives from the
inputs."""
