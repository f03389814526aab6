"""Synthetic respiratory corpora in their published layouts, for driving the
legacy OPERA benchmark from disk (chip_smoke.py phases 29-30) and for the
CPU tests that hold the port's processors and SSL preparers to the JAX
package's. Each recording carries a label-dependent tone burst in noise;
the metadata files are those the processors and preparers read, with the
cases that pandas types in its own way: empty cells (NaN), an integer
column and a float column with a gap, a True/False column, numbers in a
string column, a repeated key that no file reads, a COUGHVID recording
saved under its uuid less the last character.

  datasets/copd/           Labels.csv, RespiratoryDatabase@TR/<pid>_<ch>.wav (4 kHz)
  datasets/KAUH/           AudioFiles/BP<i>_<label>,<phase>,<site>,<age>,<sex>.wav (4 kHz)
  datasets/icbhi/          ICBHI_Challenge_diagnosis.txt, ICBHI_challenge_train_test.txt,
                           ICBHI_final_database/<pid>_<idx>_<loc>_<mode>_<equip>.{wav,txt}
                           (4, 10 and 44.1 kHz in turn, 10-30 s, annotated cycles)
  datasets/SSBPR/          <sex>/<uid>/<uid>_<k>_<position>.wav (16 kHz)
  datasets/nosemic/audio/  <uid>_a_<k>_<rate>.wav (16 kHz)
  datasets/mmlung/         All_path.xlsx, Deep_Breath/ and O_Single/<pid>.wav (16 kHz)
  datasets/coughvid/       metadata_compiled.csv, wav/<uuid>.wav
  datasets/covidUK/        audio_metadata.csv, participant_metadata.csv,
                           train_test_splits.csv, audio/*.wav
  datasets/covid19-sounds/ data_0426_en_task{1,2}.csv, test_uid.npy,
                           covid19_data_0426{,_metadata}/...
  datasets/Coswara-Data/   combined_data.csv, annotations/, Extracted_data/<date>/<id>/
  datasets/hf_lung/        HF_Lung_V1-master/{train,test}/, HF_Lung_V1_IP-main/{train,test}/
                           <stem>.wav and <stem>_label.txt (4 kHz, 15 s)

`write_xlsx` writes the minimal one-sheet workbook utils/table.py reads.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional, Sequence, Tuple
from xml.sax.saxutils import escape

import numpy as np

from ..train.legacy_tasks import NOSEMIC_UIDS
from ..utils.audio_io import write_wav

CORPORA = ("copd", "kauh", "icbhi", "ssbpr", "nosemic", "mmlung", "coughvid", "coviduk",
           "covid19sounds", "coswara", "hf_lung")
# subjects (patients, participants or, for SSBPR, snorers of 6 episodes and,
# for HF_Lung, train recordings) a corpus
SUBJECTS = {"copd": 50, "kauh": 32, "icbhi": 20, "ssbpr": 10, "nosemic": len(NOSEMIC_UIDS),
            "mmlung": 40, "coughvid": 60, "coviduk": 30, "covid19sounds": 12, "coswara": 16,
            "hf_lung": 160}


def write_xlsx(path: str, header, rows) -> None:
    """A one-sheet .xlsx: strings shared, booleans typed, numbers as written
    (an int without '.' reads back as int, as openpyxl reads it); None cells
    are left out."""
    shared, cells = [], []
    for i, row in enumerate([header] + list(rows), start=1):
        out = []
        for j, v in enumerate(row):
            ref = f"{chr(ord('A') + j)}{i}"
            if v is None:
                continue
            if isinstance(v, str):
                if v not in shared:
                    shared.append(v)
                out.append(f'<c r="{ref}" t="s"><v>{shared.index(v)}</v></c>')
            elif isinstance(v, bool):
                out.append(f'<c r="{ref}" t="b"><v>{int(v)}</v></c>')
            else:
                out.append(f'<c r="{ref}"><v>{v!r}</v></c>')
        cells.append(f'<row r="{i}">{"".join(out)}</row>')
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    rel = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
    pkg = "http://schemas.openxmlformats.org/package/2006/relationships"
    ct = "application/vnd.openxmlformats-officedocument.spreadsheetml"
    files = {
        "[Content_Types].xml": (
            '<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/package/2006/'
            'content-types"><Default Extension="rels" ContentType="application/vnd.'
            'openxmlformats-package.relationships+xml"/><Default Extension="xml" '
            'ContentType="application/xml"/><Override PartName="/xl/workbook.xml" '
            f'ContentType="{ct}.sheet.main+xml"/><Override PartName="/xl/worksheets/sheet1.xml" '
            f'ContentType="{ct}.worksheet+xml"/><Override PartName="/xl/sharedStrings.xml" '
            f'ContentType="{ct}.sharedStrings+xml"/></Types>'),
        "_rels/.rels": (
            f'<?xml version="1.0"?><Relationships xmlns="{pkg}"><Relationship Id="rId1" '
            f'Type="{rel}/officeDocument" Target="xl/workbook.xml"/></Relationships>'),
        "xl/workbook.xml": (
            f'<?xml version="1.0"?><workbook {ns} xmlns:r="{rel}"><sheets><sheet name="Sheet1" '
            'sheetId="1" r:id="rId1"/></sheets></workbook>'),
        "xl/_rels/workbook.xml.rels": (
            f'<?xml version="1.0"?><Relationships xmlns="{pkg}"><Relationship Id="rId1" '
            f'Type="{rel}/worksheet" Target="worksheets/sheet1.xml"/><Relationship Id="rId2" '
            f'Type="{rel}/sharedStrings" Target="sharedStrings.xml"/></Relationships>'),
        "xl/worksheets/sheet1.xml": (
            f'<?xml version="1.0"?><worksheet {ns}><sheetData>{"".join(cells)}</sheetData>'
            '</worksheet>'),
        "xl/sharedStrings.xml": (
            f'<?xml version="1.0"?><sst {ns}>'
            + "".join(f"<si><t>{escape(s)}</t></si>" for s in shared) + "</sst>"),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w") as z:
        for name, body in files.items():
            z.writestr(name, body)


def _text(path: str, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_resp_corpora(
    root: str,
    seed: int = 29,
    corpora: Sequence[str] = CORPORA,
    sr: Optional[int] = None,
    sec: Optional[float] = None,
    subjects: Optional[Dict[str, int]] = None,
) -> Tuple[Dict[str, int], Dict[str, list]]:
    """The named corpora above under root/datasets/, from `seed`.

    sr: every recording at this rate (default: each corpus's own, as
    listed); sec: every recording this long (default: each corpus's own
    range; a few hundredths of a second serve the processors, which only
    list files); subjects: per-corpus counts in place of SUBJECTS.

    Returns the recordings written per corpus and the columns of MMLung's
    All_path.xlsx (None for an empty cell; empty without MMLung)."""
    r = np.random.default_rng(seed)
    n_of = {**SUBJECTS, **(subjects or {})}
    d = lambda *p: os.path.join(root, "datasets", *p)
    written: Dict[str, int] = {}

    def wav(path: str, lo: float, hi: float, own_sr: int, f0: float, period: float = 1.2):
        """Noise with a tone burst of f0 Hz in the first 40% of each period,
        lo-hi seconds long (or `sec`); returns its length in seconds."""
        rate = sr or own_sr
        t = np.arange(int((sec or r.uniform(lo, hi)) * rate)) / rate
        x = 0.05 * r.standard_normal(len(t))
        x += 0.25 * ((t % period) < 0.4 * period) * np.sin(2 * np.pi * f0 * t)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(path, x.astype(np.float32), rate)
        written[corpus] = written.get(corpus, 0) + 1
        return len(t) / rate

    mmlung_table: Dict[str, list] = {}
    for corpus in corpora:
        n = n_of[corpus]
        if corpus == "copd":
            # RespiratoryDatabase@TR: two channels a patient, severity COPD0-4
            rows = ["patient,label"]
            for i in range(n):
                pid, sev = f"H{i:03d}", i % 5
                rows.append(f"{pid},COPD{sev}")
                for ch in ("L1", "R3"):
                    wav(d("copd", "RespiratoryDatabase@TR", f"{pid}_{ch}.wav"), 6, 12, 4000,
                        150 + 60 * sev)
            _text(d("copd", "Labels.csv"), rows)

        elif corpus == "kauh":
            # KAUH: 2 recordings a subject; a quarter pneumonia (dropped)
            for i in range(n):
                lab = ["N", "Asthma", "COPD", "pneumonia"][i % 4]
                for k in range(2):
                    wav(d("KAUH", "AudioFiles", f"BP{i + 1}_{lab},{'IE'[k]},P R U,{30 + i},M.wav"),
                        5, 20, 4000, 150 + 80 * (i % 4))

        elif corpus == "icbhi":
            # ICBHI 2017: 3 recordings a patient at 4 / 10 / 44.1 kHz in turn,
            # the official split by patient, cycles of 1.5-4 s with crackle /
            # wheeze flags; COPD patients wheeze (a 400 Hz burst). Patient 107
            # has an empty diagnosis cell (NaN); 199 is a repeated key that
            # no file reads
            kinds = ["Healthy", "COPD", "URTI", "COPD", "Healthy", "Pneumonia", "COPD",
                     "Bronchiectasis"]
            diag, split = [], []
            for p in range(n):
                pid = str(101 + p)
                disease = "" if pid == "107" else kinds[p % len(kinds)]
                diag.append(f"{pid}\t{disease}")
                for j in range(3):
                    name = (f"{pid}_{j + 1}b1_{['Al', 'Tc', 'Pr'][j]}_sc_"
                            f"{['Meditron', 'LittC2SE', 'AKGC417L'][j]}")
                    dur = wav(d("icbhi", "ICBHI_final_database", name + ".wav"), 10, 30,
                              (4000, 10000, 44100)[(3 * p + j) % 3],
                              400 if disease == "COPD" else 180)
                    ann, t0 = [], 0.0
                    while t0 < dur - 0.5 or not ann:
                        t1 = min(t0 + float(r.uniform(1.5, 4.0)), dur)
                        ann.append(f"{t0:.3f}\t{t1:.3f}\t{int(r.random() < 0.3)}\t"
                                   f"{int(disease == 'COPD' and r.random() < 0.5)}")
                        t0 = t1
                    _text(d("icbhi", "ICBHI_final_database", name + ".txt"), ann)
                    split.append(f"{name}\t{'test' if p % 3 == 0 else 'train'}")
            _text(d("icbhi", "ICBHI_Challenge_diagnosis.txt"), diag + ["199\tCOPD", "199\tAsthma"])
            _text(d("icbhi", "ICBHI_challenge_train_test.txt"), split)

        elif corpus == "ssbpr":
            # SSBPR: 6 snoring episodes a snorer, body position 0-5 as the
            # last digit (5 is dropped)
            for i in range(6 * n):
                pos, uid = i % 6, f"u{i // 6:02d}"
                wav(d("SSBPR", "male" if i % 2 else "female", uid, f"{uid}_{i}_{pos}.wav"),
                    3, 8, 16000, 120 + 40 * pos, period=2.0)

        elif corpus == "nosemic":
            # NoseMic: 3 recordings a subject; the breathing rate (breaths a
            # minute) in the name sets the burst period
            for uid in NOSEMIC_UIDS[:n]:
                for j in range(3):
                    rate = float(np.round(r.uniform(10, 25), 1))
                    wav(d("nosemic", "audio", f"{uid}_a_{j}_{rate}.wav"), 10, 20, 16000, 200,
                        period=60.0 / rate)

        elif corpus == "mmlung":
            # MMLung: a deep breath and a vowel a participant; FVC an integer
            # column, FEV1/FVC with a gap
            mmlung_table = {c: [] for c in ("ID", "FVC", "FEV1", "FEV1/FVC", "Deep_Breath_file",
                                            "O_Single_file")}
            for i in range(n):
                fvc = int(r.integers(2, 6))
                fev1 = round(fvc * float(r.uniform(0.5, 0.9)), 2)
                for c, v in zip(mmlung_table, (f"P{i:02d}", fvc, fev1,
                                               None if i == 4 else round(fev1 / fvc, 3),
                                               f"./Deep_Breath/P{i:02d}.wav",
                                               f"./O_Single/P{i:02d}.wav")):
                    mmlung_table[c].append(v)
                for sub in ("Deep_Breath", "O_Single"):
                    wav(d("mmlung", sub, f"P{i:02d}.wav"), 5, 10, 16000, 100 + 40 * fvc)
            header = list(mmlung_table)
            write_xlsx(d("mmlung", "All_path.xlsx"), header,
                       [[mmlung_table[c][i] for c in header] for i in range(n)])

        elif corpus == "coughvid":
            # COUGHVID: empty gender / status / age cells, a recording saved
            # under its uuid less the last character
            rows = ["uuid,cough_detected,gender,status,age"]
            for i in range(n):
                u = f"{i:04x}-c0ffee-{i % 7}a"
                g = ["female", "male", ""][i % 3] if i % 11 else "other"
                s = ["healthy", "COVID-19", "symptomatic", ""][i % 4]
                rows.append(f"{u},{r.uniform(0.5, 1.0):.3f},{g},{s},{'' if i % 5 == 0 else 20 + i}")
                wav(d("coughvid", "wav", (u[:-1] if i % 13 == 0 else u) + ".wav"), 1, 8, 16000,
                    200 + 100 * (i % 4))
            _text(d("coughvid", "metadata_compiled.csv"), rows)

        elif corpus == "coviduk":
            # UK COVID-19 Vocal Audio: the exhalation file name in column 1,
            # the cough's in column 9 (empty for some participants)
            rows = ["participant_identifier,exhalation_file_name,"
                    + ",".join(f"c{j}" for j in range(2, 9)) + ",cough_file_name"]
            users = ["participant_identifier,covid_test_result,age"]
            splits = ["participant_identifier,splits"]
            for i in range(n):
                p, pos = f"P{i:03d}", i % 3 == 0
                cough = "" if i % 7 == 3 else f"cough_{p}.wav"
                rows.append(f"{p},exh_{p}.wav," + ",".join(str(j) for j in range(2, 9))
                            + f",{cough}")
                users.append(f"{p},{'Positive' if pos else 'Negative'},{30 + i}")
                splits.append(f"{p},{['train', 'train', 'val', 'test'][i % 4]}")
                for f in (f"exh_{p}.wav", cough):
                    if f:
                        wav(d("covidUK", "audio", f), 3, 9, 16000, 350 if pos else 200)
            _text(d("covidUK", "audio_metadata.csv"), rows)
            _text(d("covidUK", "participant_metadata.csv"), users)
            _text(d("covidUK", "train_test_splits.csv"), splits)

        elif corpus == "covid19sounds":
            # COVID-19 Sounds: task 1 and 2 tables, per-chunk metadata with
            # check columns (an empty cell among them), recordings under
            # uid/folder/ (a read passage in place of the voice for some)
            task1 = ["Uid;Folder Name;Cough filename;Breath filename;label;split"]
            task2 = ["uid,fold"]
            meta = ["Uid;Folder Name;Breath check;Cough check;Voice check"]
            uids = [f"U{i:02d}x" for i in range(n - 2)] + ["2020-04-07-1", "2020-04-08-2"]
            for i, u in enumerate(uids):
                folder = f"2020-05-{i + 1:02d}-{u[-2:]}"
                task1.append(f"{u};{folder};cough_{i}.wav;breath_{i}.wav;{i % 2};{i % 3}")
                task2.append(f"{u},{'test' if i == 7 else 'train'}")
                meta.append(f"{u};{folder};{'b' if i % 4 else ''};{'c' if i % 3 else 'x'};v")
                for kind in ("breath", "cough", "read" if i % 2 else "voice"):
                    wav(d("covid19-sounds", "covid19_data_0426", u, folder, f"{kind}_{i}.wav"),
                        3, 20, 16000, 200 + 150 * (i % 2))
            _text(d("covid19-sounds", "data_0426_en_task1.csv"), task1)
            _text(d("covid19-sounds", "data_0426_en_task2.csv"), task2)
            np.save(d("covid19-sounds", "test_uid.npy"), np.array(["U05x"]))
            _text(d("covid19-sounds", "covid19_data_0426_metadata", "2020-05.csv"), meta)

        elif corpus == "coswara":
            # Coswara: a smoker column mixing y / n / True / False and empty
            # cells; some modalities missing on disk
            rows = ["id,g,smoker,a"]
            mods = ["breathing-deep", "breathing-shallow", "cough-heavy", "cough-shallow"]
            ann = {m: ["FILENAME,QUALITY"] for m in mods}
            for i in range(n):
                u = f"cw{i:02d}Ab"
                sm = ["y", "n", "True", "False", "", "TRUE"][i % 6]
                rows.append(f"{u},{['female', 'male', ''][i % 3]},{sm},{i}")
                for j, m in enumerate(mods):
                    ann[m].append(f"{u}_{m},{(i + j) % 3}")
                    if (i + j) % 5:
                        wav(d("Coswara-Data", "Extracted_data", f"2020041{i % 3}", u, m + ".wav"),
                            3, 10, 16000, 200 + 100 * (i % 2))
            _text(d("Coswara-Data", "combined_data.csv"), rows)
            for m in mods:
                _text(d("Coswara-Data", "annotations", f"{m}_labels.csv"), ann[m])

        elif corpus == "hf_lung":
            # HF_Lung_V1 and its IP extension: n train recordings in the
            # first, a tenth as many in the second and in each test dir,
            # each with its label txt
            dirs = (("HF_Lung_V1-master", "train", n), ("HF_Lung_V1_IP-main", "train", n // 10),
                    ("HF_Lung_V1-master", "test", n // 10), ("HF_Lung_V1_IP-main", "test", n // 10))
            for base, split, count in dirs:
                for k in range(max(1, count)):
                    stem = f"steth_{base[-4:]}_{split}_{k:04d}"
                    wav(d("hf_lung", base, split, stem + ".wav"), 15, 15, 4000,
                        150 + 250 * (k % 2))
                    _text(d("hf_lung", base, split, stem + "_label.txt"),
                          [["", "Wheeze", "Stridor Rhonchi", "Wheeze Stridor Rhonchi"][k % 4]])
        else:
            raise ValueError(f"unknown corpus {corpus!r}; known: {CORPORA}")
    return written, mmlung_table
