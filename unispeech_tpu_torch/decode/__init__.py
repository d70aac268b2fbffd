from unispeech_tpu_torch.decode.beam import CtcBeamDecoder, KenLMWrapper, best_path_decode
from unispeech_tpu_torch.decode.wer import WerScorer, edit_distance, post_process

__all__ = [
    "CtcBeamDecoder",
    "KenLMWrapper",
    "best_path_decode",
    "WerScorer",
    "edit_distance",
    "post_process",
]
