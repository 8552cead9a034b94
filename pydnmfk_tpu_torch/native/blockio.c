/* Strided block reader: the IO hot path of the data loader.
 *
 * A copy of pydnmfk_tpu/native/blockio.c for pydnmfk_tpu_torch. The
 * reference framework's loader has every rank read the FULL input file and
 * slice its block in Python (pyDNMFk/data_io.py:92-105). This reads
 * exactly the bytes of one (row-range x col-range) block of a row-major
 * on-disk matrix with one pread per row, no GIL (called via ctypes), no
 * Python per-row overhead. The .npy header is parsed on the Python side
 * (native/__init__.py); this file is pure byte plumbing, so it works for
 * any fixed-stride container.
 *
 * Built at first use by native/__init__.py:
 *   cc -O2 -shared -fPIC blockio.c -o build/pydnmfk_tpu_torch/blockio-<hash>.so
 */
#include <fcntl.h>
#include <stdint.h>
#include <unistd.h>

/* Read `nrows` spans of `row_bytes` starting at file offset `offset0`,
 * advancing `row_stride` bytes per row, into contiguous `out`.
 * Returns 0 on success, -1 on open failure, -2 on short read. */
int read_block(const char *path, int64_t offset0, int64_t row_stride,
               int64_t row_bytes, int64_t nrows, char *out)
{
    int fd = open(path, O_RDONLY);
    if (fd < 0)
        return -1;
#ifdef POSIX_FADV_SEQUENTIAL
    posix_fadvise(fd, offset0, nrows * row_stride, POSIX_FADV_SEQUENTIAL);
#endif
    for (int64_t i = 0; i < nrows; ++i) {
        int64_t off = offset0 + i * row_stride;
        char *dst = out + i * row_bytes;
        int64_t remaining = row_bytes;
        while (remaining > 0) {
            ssize_t got = pread(fd, dst, (size_t)remaining, off);
            if (got <= 0) {
                close(fd);
                return -2;
            }
            dst += got;
            off += got;
            remaining -= got;
        }
    }
    close(fd);
    return 0;
}
