from setuptools import find_packages, setup


def read_version():
    with open('stable_ts_tpu/_version.py') as f:
        return f.read().split('=')[1].strip().strip('"').strip("'")


setup(
    name='stable-ts-tpu',
    version=read_version(),
    description='TPU-native word-level timestamp stabilization for Whisper '
                '(JAX/XLA/Pallas)',
    python_requires='>=3.10',
    packages=find_packages(exclude=['tests*']),
    package_data={'stable_ts_tpu': ['native/*.cpp'],
                  'stable_ts_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    install_requires=[
        'numpy',
        'jax',
        'scipy',
    ],
    extras_require={
        'train': ['optax'],
        'torch-checkpoints': ['torch'],  # only for reading OpenAI .pt files
        # the PyTorch + CUDA port (stable_ts_tpu_torch); its kernels build
        # with nvcc at first use
        'torch': ['torch'],
    },
    entry_points={
        'console_scripts': ['stable-ts-tpu=stable_ts_tpu.cli:cli'],
    },
)
