"""The yardstick's arithmetic, frozen with the benchmark: the peaks of one
H100 (``peaks``), the operations a piece of work needs whatever implements
it (``mfcc``, ``smallcnn``), each hand-written kernel's least time a call
(one file a kernel, named after it), and each configuration's step counts
(one file a configuration, named after it, found by ``harness.load_module``).

Conventions: a product or convolution counts 2 operations a multiply-add; a
backward pass counts the gradients it has to produce; recomputed work is not
counted; a kernel's bytes count each input read once and each output
written once.
"""
