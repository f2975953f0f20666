"""CTC fine-tuning of the Wav2Vec2Bert encoder (port of training/)."""
