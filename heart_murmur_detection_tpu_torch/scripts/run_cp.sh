#!/bin/sh
# Continued-pretraining runbook (mirrors reference scripts/run_cp.sh).
# Prepare SSL spectrograms, then run COLA / Audio-MAE CP on heart corpora.

# 1) data prep (per corpus; input_sec 8, pascal uses 2)
python - <<'EOF'
from heart_murmur_detection_tpu_torch.pretrain import prepare
for d, sec in [("circor", 8), ("physionet16", 8), ("zchsound_clean", 8),
               ("zchsound_noisy", 8), ("pascal_A", 2), ("pascal_B", 2)]:
    prepare.preprocess_spectrogram_ssl(f"feature/{d}_eval/", input_sec=sec)
    prepare.preprocess_spectrogram_ssl_audiomae(f"feature/{d}_eval/", input_sec=10)
EOF

# 2) COLA CP, all heart corpora, warm-start from OPERA-CT (H2 heart-all).
# compute_dtype=bfloat16 runs the encoder's swin blocks on the train kernels
# of the card; drop it for the strict float32 path.
python -m heart_murmur_detection_tpu_torch.cli.pretrain \
  circor=True pascal_A=True pascal_B=True physionet16=True \
  zchsound_clean=True zchsound_noisy=True \
  encoder=htsat pretrain=operaCT title=operaCT-heart-all epoches=250 method=cola \
  compute_dtype=bfloat16

# Several cards: add dp=N for N-way data parallelism (one gradient
# all-reduce a step), or dp=N tp=M for a 2-D mesh with Megatron
# tensor-sharded params (param_sharding=fsdp for ZeRO-3-style placement);
# dp=N param_sharding=fsdp without tp is ZeRO-3 over the data axis. N*M
# cards must exist (the gloo backend on the CPU runs the ranks without one).
#   ... encoder=htsat pretrain=operaCT title=... dp=4 tp=2

# 3) COLA CP from scratch (H2.1)
# python -m heart_murmur_detection_tpu_torch.cli.pretrain \
#   circor=True pascal_A=True pascal_B=True physionet16=True \
#   zchsound_clean=True zchsound_noisy=True \
#   encoder=htsat pretrain=None title=operaCT-heart-all-scratch epoches=250 method=cola

# 4) Audio-MAE CP (H3)
# python -m heart_murmur_detection_tpu_torch.cli.pretrain \
#   circor=True pascal_A=True pascal_B=True physionet16=True \
#   zchsound_clean=True zchsound_noisy=True \
#   pretrain=audiomae title=audiomae-heart-all epoches=250 method=audiomae

# 5) in-domain variants (leave-one-out / single-corpus): toggle the corpus
#    flags and set title accordingly, e.g. circor=True title=operaCT-circor-indomain
