from .dataset import (EvalImageDataset, ImageFolderDataset,
                      prefetch_batches)
