"""Download Google Speech Commands v0.01 / v0.02 (port of
audiobd_tpu/cli/get_dataset.py; reference get_dataset.py).

    python -m audiobd_tpu_torch get_dataset [--version 0.01|0.02|both] [--root data]

The standard library's urllib and tarfile, extracting into the
``data/SpeechCommands/speech_commands_v0.0X`` layout that the ingest
(``configs.DATASET_PATHS``) reads. A populated target is left as it is; an
archive already on disk is extracted without a download, so a host without
network access can be given the archive by hand.
"""

from __future__ import annotations

import argparse
import os
import tarfile
import urllib.request

URLS = {
    "0.01": "https://storage.googleapis.com/download.tensorflow.org/data/speech_commands_v0.01.tar.gz",
    "0.02": "https://storage.googleapis.com/download.tensorflow.org/data/speech_commands_v0.02.tar.gz",
}


def download(version: str, root: str = "data") -> str:
    url = URLS[version]
    target_dir = os.path.join(root, "SpeechCommands", f"speech_commands_v{version}")
    if os.path.isdir(target_dir) and any(os.scandir(target_dir)):
        print(f"{target_dir} already populated, skipping")
        return target_dir
    os.makedirs(target_dir, exist_ok=True)
    archive = os.path.join(root, f"speech_commands_v{version}.tar.gz")
    if not os.path.exists(archive):
        print(f"downloading {url} ...")
        urllib.request.urlretrieve(url, archive)
    print(f"extracting to {target_dir} ...")
    with tarfile.open(archive) as tar:
        tar.extractall(target_dir, filter="data")
    return target_dir


def main(argv: list[str] | None = None) -> list[str]:
    """Returns the target directories that were populated."""
    parser = argparse.ArgumentParser(description="Download Speech Commands")
    parser.add_argument("--version", choices=["0.01", "0.02", "both"], default="both")
    parser.add_argument("--root", type=str, default="data")
    args = parser.parse_args(argv)
    versions = ["0.01", "0.02"] if args.version == "both" else [args.version]
    done = []
    for version in versions:
        try:
            done.append(download(version, args.root))
        except (OSError, tarfile.TarError) as e:  # urllib's errors are OSErrors
            print(f"download of v{version} failed ({e}); if this host has no "
                  f"egress, fetch the archive manually and place it at "
                  f"{args.root}/speech_commands_v{version}.tar.gz")
    return done


if __name__ == "__main__":
    main()
