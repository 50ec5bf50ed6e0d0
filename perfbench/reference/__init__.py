"""The plain reference that decides ``correct``: Whisper in f32 (TF32 off)
written from the published model, with the decoding rules and the word
timing of stable-ts, and the lower-precision control. It imports neither
JAX nor ``stable_ts_tpu`` nor ``stable_ts_tpu_torch``, and takes from the
program only the outputs it judges."""
