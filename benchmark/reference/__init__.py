"""The plain reference the benchmark judges the port's outputs by.

Plain PyTorch and NumPy, frozen copies of the default paths of the
port's extractor, projection matcher, pose LM, SAD stereo, track
generator and renderer. It imports nothing of
slam_toolkit_tpu_torch (nor jax, nor slam_toolkit_tpu), and takes its
settings from the benchmark's configuration files, so a change to the
port cannot move it.
"""
