"""Downstream heads on frozen SSL features: ECAPA-TDNN speaker verification
(``ecapa_tdnn``, the ``verification`` CLI) and EEND diarization
(``diarization``, the ``diarize`` CLI)."""
