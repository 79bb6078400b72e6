"""Training failures (counterpart of ``deepqmc_tpu/exceptions.py``)."""


class DeepQMCError(Exception):
    pass


class NanError(DeepQMCError):
    """Raised when NaNs appear in the sampled wave function values."""


class TrainingBlowup(DeepQMCError):
    """Raised when the training loss diverges."""


class TrainingCrash(DeepQMCError):
    """Terminal failure carrying the last healthy train state."""

    def __init__(self, train_state):
        super().__init__()
        self.train_state = train_state
