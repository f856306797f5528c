"""Hand-written Hopper (sm_90a) kernels, one module per TPU kernel of
`nn_conformer_for_speech_recognition_tpu/ops/pallas/`.

Each module holds the kernel's wrapper, its plain PyTorch twin and a launch
counter (``wrapper.launches``).  The wrapper runs the twin only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
"""
