"""Compute ops of the port: the log-mel front end and median filter in
plain torch, and the four CUDA kernels (flash attention, self- and
cross-attention decode, DTW cost), each beside its plain twin."""
