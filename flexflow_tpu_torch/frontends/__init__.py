"""Frontends of the port: ``keras`` (the tf.keras-style API over
``FFModel``)."""
