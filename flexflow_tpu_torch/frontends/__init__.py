"""Frontends of the port: ``keras`` (the tf.keras-style API over
``FFModel``), ``onnx`` (the ONNX graph importer, with
``InferenceModel.from_onnx``) and ``torch`` (the torch.fx importer and
the ``.ff`` file)."""
