"""Model facades."""

from .phase_vocoder import PhaseVocoder  # noqa: F401
