"""Model import: Keras HDF5 files into port networks (modelimport/keras.py),
read with the port's own HDF5 module (modelimport/hdf5.py), and DL4J
ModelSerializer zips (modelimport/dl4j.py)."""
from deeplearning4j_tpu_torch.modelimport.keras import (  # noqa: F401
    KerasModelImport,
    import_keras_model_and_weights,
    import_keras_model_configuration,
    import_keras_sequential_configuration,
    import_keras_sequential_model_and_weights,
)
from deeplearning4j_tpu_torch.modelimport.dl4j import (  # noqa: F401
    restore_computation_graph,
    restore_multi_layer_network,
    restore_normalizer,
)
