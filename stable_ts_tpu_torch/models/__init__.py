"""Model families of the port (Whisper)."""
