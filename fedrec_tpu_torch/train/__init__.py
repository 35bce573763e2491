from fedrec_tpu_torch.train.step import encode_all_news

__all__ = ["encode_all_news"]
