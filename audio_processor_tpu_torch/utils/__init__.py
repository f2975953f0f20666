from audio_processor_tpu_torch.utils.text import remove_special_characters

__all__ = ["remove_special_characters"]
