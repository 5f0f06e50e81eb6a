from .dataset import EvalImageDataset
