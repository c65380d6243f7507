from rgie_tpu_torch.data.dataset import (CaptionFeedDataset, CocoCaptionsDataset,
                                         ImageDirectoryDataset, first_caption, iterate_batches,
                                         load_image_rgb, preprocess_image)

__all__ = ["CaptionFeedDataset", "CocoCaptionsDataset", "ImageDirectoryDataset", "first_caption",
           "iterate_batches", "load_image_rgb", "preprocess_image"]
