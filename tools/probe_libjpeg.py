#!/usr/bin/env python3
"""Whether this machine can build against libjpeg: the ``jpeglib.h``
header (compiled into a one-line C program) and a link with ``-ljpeg``.
Prints one JSON object and exits 0 either way.

    python3 tools/probe_libjpeg.py
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

SOURCE = """#include <stdio.h>
#include <jpeglib.h>
int main(void) {
    struct jpeg_decompress_struct d;
    struct jpeg_error_mgr e;
    d.err = jpeg_std_error(&e);
    jpeg_create_decompress(&d);
    jpeg_destroy_decompress(&d);
    printf("%d\\n", JPEG_LIB_VERSION);
    return 0;
}
"""


def _run(cmd, cwd):
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       timeout=60)
    return p.returncode, (p.stdout + p.stderr).strip()[-400:]


def main():
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    out = {"compiler": cc,
           "headers": [p for p in ("/usr/include/jpeglib.h",
                                   "/usr/local/include/jpeglib.h")
                       if os.path.exists(p)]}
    if cc is None:
        out.update(compiles=False, links=False, reason="no C compiler")
        print(json.dumps(out))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "probe.c"), "w") as f:
            f.write(SOURCE)
        rc, log = _run([cc, "-c", "probe.c", "-o", "probe.o"], tmp)
        out["compiles"] = rc == 0
        if rc:
            out["compile_log"] = log
        rc, log = _run([cc, "probe.o" if out["compiles"] else "probe.c",
                        "-o", "probe", "-ljpeg"], tmp)
        out["links"] = rc == 0
        if rc:
            out["link_log"] = log
        else:
            rc, log = _run(["./probe"], tmp)
            out["jpeg_lib_version"] = log if rc == 0 else None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
