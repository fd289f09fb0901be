"""The speech recipes (the port's copies of whisper_tensor_tpu/importers/
recipes/speech/)."""
