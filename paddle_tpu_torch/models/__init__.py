"""Model builders of the PyTorch port."""
from .bert import BertConfig, build_bert_pretrain  # noqa: F401
from .deepfm import build_deepfm  # noqa: F401
from .gpt import (GptConfig, build_gpt_chunk, build_gpt_decode,  # noqa: F401
                  build_gpt_generative, build_gpt_prefill)
from .mlp import build_mnist_mlp  # noqa: F401
from .resnet import build_resnet  # noqa: F401
from .seq2seq import (build_seq2seq_infer, build_seq2seq_train,  # noqa: F401
                      build_seq2seq_train_varlen)
