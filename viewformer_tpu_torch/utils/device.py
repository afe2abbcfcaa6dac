"""Where the port's entry points put their tensors: on the card unless the
caller asks for the CPU (device='cpu'). There is no fallback to the CPU."""
import torch


def resolve_device(device):
    """torch.device(device); raises when it names a CUDA device and none is
    available."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device is available for device={str(device)!r}; '
                           "pass device='cpu' to run on the CPU")
    return device
