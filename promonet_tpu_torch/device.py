"""Device selection for the public entry points"""
import torch


def resolve(device):
    """The torch device an entry point runs on

    Entry points default to 'cuda'. A CUDA device on a host without one
    raises: the port never moves work to the CPU on its own.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA device requested but torch.cuda.is_available() is False; '
            "pass device='cpu' to run the plain PyTorch path")
    return device
