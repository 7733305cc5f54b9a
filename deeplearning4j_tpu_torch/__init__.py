"""deeplearning4j_tpu_torch — the PyTorch and CUDA port of deeplearning4j_tpu.

The JAX package `deeplearning4j_tpu` stays beside this one as the reference
each slice of the port is tested against; this package imports neither it
nor JAX. Module paths and class names mirror the JAX package, so
`deeplearning4j_tpu_torch/nn/layers/normalization.py:BatchNorm` is the
counterpart of `deeplearning4j_tpu/nn/layers/normalization.py:BatchNorm`.

Layout of the ported slices (ResNet-50 and TransformerLM served by
InferenceServer):
    device.py   device resolution: CUDA unless the caller asks for the CPU
    dtypes.py   precision policy (TF32, bf16 activations)
    nn/         config DSL, layers, activations, initializers
    ops/        dot/conv and attention primitives, the hand-written CUDA
                kernels' wrappers (bn_act, flash_attention)
    csrc/       CUDA C++ sources, built at first use by ops/_build.py
    models/     ComputationGraph and MultiLayerNetwork inference runtimes
    zoo/        ResNet50, TransformerLM
    modelimport/  Keras .h5 import (keras.py), InceptionV3 and its
                preprocessing (trainedmodels.py), an HDF5 reader and
                writer in plain Python (hdf5.py)
    interop.py  carries JAX-package weights into a port network
    serving/    InferenceServer with admission, shedding, circuit breaking

Activations keep the JAX package's layout at public functions: NHWC images,
BTF [b, t, f] sequences, [b, h, t, d] attention heads, [n_in, n_out] dense
weights and HWIO conv weights in the interchange form (`get_param_table`,
`interop`).
"""

__version__ = "0.1.0"
