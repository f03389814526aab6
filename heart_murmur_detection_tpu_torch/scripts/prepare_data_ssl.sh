#!/bin/sh
# SSL spectrogram preparation for all heart corpora (reference scripts/
# prepare_data_ssl.sh); run after the processors have created feature dirs.
python - <<'EOF'
from heart_murmur_detection_tpu_torch.pretrain import prepare
for d, sec in [("circor", 8), ("physionet16", 8), ("zchsound_clean", 8),
               ("zchsound_noisy", 8), ("pascal_A", 2), ("pascal_B", 2)]:
    prepare.preprocess_spectrogram_ssl(f"feature/{d}_eval/", input_sec=sec)
    prepare.preprocess_spectrogram_ssl_audiomae(f"feature/{d}_eval/", input_sec=10)
# in-domain variants (train_pretrain halves) for circor / physionet16
for d in ("circor", "physionet16"):
    prepare.preprocess_spectrogram_ssl(f"feature/{d}_eval/", input_sec=8, in_domain=True)
    prepare.preprocess_spectrogram_ssl_audiomae(f"feature/{d}_eval/", input_sec=10, in_domain=True)
EOF

# Respiratory SSL corpora (reference src/pretrain/prepare_data/*_pressl.py);
# uncomment per-corpus once the raw datasets/ trees are in place.
# python - <<'PYEOF'
# from heart_murmur_detection_tpu_torch.pretrain import prepare
# prepare.preprocess_covid19sounds_ssl(modality="breath", input_sec=8)
# prepare.preprocess_covid19sounds_ssl(modality="cough", input_sec=2)
# prepare.preprocess_covid19sounds_ssl(modality="voice", input_sec=8)
# prepare.preprocess_coughvid_ssl(input_sec=2)
# prepare.preprocess_coviduk_ssl(modality="exhalation", input_sec=4)
# prepare.preprocess_coviduk_ssl(modality="cough", input_sec=2)
# prepare.preprocess_hflung_ssl(input_sec=8)
# prepare.preprocess_icbhi_entire()
# prepare.preprocess_icbhi_cycles()
# PYEOF
