"""DSP ops of the port: windows, STFT, mel, VAD, resampling."""
