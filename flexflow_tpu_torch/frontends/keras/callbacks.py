"""Keras callbacks (port of ``flexflow_tpu/frontends/keras/callbacks.py``;
reference: python/flexflow/keras/callbacks.py:21-85)."""
from __future__ import annotations


class Callback:
    """Reference: callbacks.py:21."""

    def __init__(self):
        self.model = None

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass


class LearningRateScheduler(Callback):
    """Reference: callbacks.py:49 — calls schedule(epoch) and updates the
    optimizer lr (a device scalar in opt_state: a captured step takes
    it with no re-capture)."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        lr = self.schedule(epoch)
        self.model.set_learning_rate(float(lr))


class VerifyMetrics(Callback):
    """Reference: callbacks.py:64 — assert final accuracy above threshold."""

    def __init__(self, accuracy=0.0):
        super().__init__()
        self.accuracy = accuracy
        self.last = None

    def on_epoch_end(self, epoch, logs=None):
        self.last = logs

    def on_train_end(self, logs=None):
        if self.last is not None and hasattr(self.last, "accuracy"):
            assert self.last.accuracy >= self.accuracy, (
                f"accuracy {self.last.accuracy} < expected {self.accuracy}"
            )


class EpochVerifyMetrics(Callback):
    """Reference: callbacks.py:75 — assert accuracy every epoch."""

    def __init__(self, accuracy=0.0):
        super().__init__()
        self.accuracy = accuracy

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None and hasattr(logs, "accuracy"):
            assert logs.accuracy >= self.accuracy
