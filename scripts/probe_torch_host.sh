#!/usr/bin/env bash
# What a machine offers the port's host libraries (io/native): libtiff's and
# libjpeg's headers, the shared libraries the loader knows, the copy of
# libtiff that Pillow's wheel carries, the C++ compilers that build OpenMP
# code, and the free disk for a CAMELYON16-sized slide. Prints only; run it
# from anywhere:
#
#     bash scripts/probe_torch_host.sh
set -u
echo "== headers"
ls /usr/include/tiffio.h /usr/include/*/tiffio.h /usr/include/jpeglib.h \
    /usr/include/*/jpeglib.h /usr/include/zlib.h 2>&1
grep -h 'define TIFFLIB_VERSION_STR' /usr/include/tiffvers.h \
    /usr/include/*/tiffvers.h 2>/dev/null
echo "== libraries the loader knows"
ldconfig -p | grep -E 'libtiff|libjpeg|libz\.so|libgomp' || echo "(none)"
echo "== Pillow and the libraries its wheel carries"
python3 - <<'EOF'
import importlib.util, pathlib
spec = importlib.util.find_spec("PIL")
if spec is None:
    print("no Pillow")
else:
    from PIL import __version__, features
    print("Pillow", __version__, "libtiff", features.version("libtiff"),
          "libjpeg", features.version("jpg"))
    libs = pathlib.Path(spec.origin).parent.parent / "pillow.libs"
    print(sorted(p.name for p in libs.glob("lib*")) if libs.is_dir() else
          "no pillow.libs")
for name in ("matplotlib", "cv2"):
    print(name, "present" if importlib.util.find_spec(name) else "missing")
EOF
echo "== C++ compilers with OpenMP (\$CXX=${CXX:-unset})"
err=$(mktemp)
for cxx in ${CXX:-} c++ g++; do
    path=$(command -v "$cxx") || continue
    if printf '#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n' |
            "$path" -fopenmp -x c++ -o /dev/null - 2>"$err"; then
        echo "$path: OpenMP ok ($("$path" --version | head -n 1))"
    else
        echo "$path: OpenMP fails: $(head -n 1 "$err")"
    fi
done
rm -f "$err"
echo "== free disk"
df -h "${TMPDIR:-/tmp}" /
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
