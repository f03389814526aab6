from . import embeddings, logs, masked_spec, rank, saliency, significance
