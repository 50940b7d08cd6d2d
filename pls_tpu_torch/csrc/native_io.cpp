// The port's host runtime: a headerless-CSV reader with the reference's
// diagnostics, its double-buffered chunk reader, and libstdc++'s
// std::mt19937 / std::shuffle draws.
//
// Counterpart of the JAX package's CPython extension (native/pls_native.cpp,
// `pls_tpu._native`): the same four functions with the same results and
// messages, behind a plain C interface that pls_tpu_torch/utils/native.py
// loads with ctypes.  Built with the host C++ compiler at first use
// (pls_tpu_torch/utils/cxx.py: -std=c++17 -O3 -shared -fPIC -pthread);
// it needs neither CPython's nor numpy's headers.
//
//   pio_read_matrix / pio_matrix_take      read a whole file (two calls:
//                                          parse and size, then copy out)
//   pio_chunk_open / _next / _copy / _close
//                                          a reader whose one background
//                                          thread parses chunk n+1 while the
//                                          caller uses chunk n
//   pio_gcc_shuffle_trace, pio_mt19937_raw real libstdc++ draws, the ground
//                                          truth of utils/gcc_rng.py
//
// Parsing is strtod's, field by field, as the JAX extension's parse_line:
// a trailing '\r' is stripped, blanks after a field are skipped (but for a
// tab or space separator, which the JAX extension skips as a blank too and
// so cannot read; the port reads such files as the JAX package's Python
// parser does), fields are split by one separator character, and errors read
//   "non-numeric field in F row R", "unexpected character 'c' in F row R",
//   "Error: row R has N columns, but previous row(s) have M columns.",
//   "F is empty", "cannot open F".
// Lines are those of std::getline (split on '\n'; a last line without one
// counts when it is not empty), read here in large blocks with fread.
//
// Error reporting: each entry point that can fail returns a status or a
// null handle and writes the message into the caller's buffer; `kind` is
// PIO_VALUE (a ValueError in the JAX extension) or PIO_OS (an OSError).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <numeric>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int PIO_OK = 0;
constexpr int PIO_VALUE = 1;
constexpr int PIO_OS = 2;

std::atomic<long> g_live_readers{0};  // chunk readers whose thread is not yet joined

void set_error(char *err, long errlen, const std::string &msg) {
    if (err == nullptr || errlen <= 0) return;
    size_t n = std::min(msg.size(), static_cast<size_t>(errlen - 1));
    std::memcpy(err, msg.data(), n);
    err[n] = '\0';
}

// std::getline over a FILE*, in blocks: next() hands out each line in
// place, NUL-terminated (its '\n' overwritten), valid until the next call.
class LineReader {
  public:
    explicit LineReader(std::FILE *f) : f_(f), buf_(1 << 20) {}
    ~LineReader() {
        if (f_) std::fclose(f_);
    }

    bool next(char *&line, size_t &len) {
        for (;;) {
            char *base = buf_.data();
            char *nl = static_cast<char *>(std::memchr(base + start_, '\n', end_ - start_));
            if (nl != nullptr) {
                line = base + start_;
                len = static_cast<size_t>(nl - line);
                *nl = '\0';
                start_ = static_cast<size_t>(nl - base) + 1;
                return true;
            }
            if (eof_) {
                if (start_ == end_) return false;
                // the last line has no '\n': terminate it in the spare byte
                line = base + start_;
                len = end_ - start_;
                line[len] = '\0';
                start_ = end_;
                return true;
            }
            fill();
        }
    }

  private:
    void fill() {
        if (start_ > 0) {  // keep the partial line, at the front
            std::memmove(buf_.data(), buf_.data() + start_, end_ - start_);
            end_ -= start_;
            start_ = 0;
        }
        if (buf_.size() - end_ < (1 << 16) + 1) buf_.resize(buf_.size() * 2);
        // one byte stays free, for the NUL after a last line without '\n'
        size_t got = std::fread(buf_.data() + end_, 1, buf_.size() - end_ - 1, f_);
        end_ += got;
        if (got == 0) eof_ = true;
    }

    std::FILE *f_;
    std::vector<char> buf_;
    size_t start_ = 0, end_ = 0;
    bool eof_ = false;
};

// Parse one line (NUL-terminated at line[len]) into `out`; returns its
// column count, or -1 with `err` set.
long parse_line(char *line, size_t len, char sc, long row_index, const char *filename,
                std::vector<double> &out, std::string &err) {
    if (len > 0 && line[len - 1] == '\r') line[--len] = '\0';
    const char *p = line;
    const char *end = line + len;
    long cols = 0;
    for (;;) {
        char *next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) {
            err = "non-numeric field in " + std::string(filename) + " row " +
                  std::to_string(row_index);
            return -1;
        }
        out.push_back(v);
        cols++;
        p = next;
        // blanks after a field, but not the separator itself: the JAX
        // extension skips a tab or space separator here too, and so refuses
        // every tab- or space-separated row of two or more fields
        while (p < end && (*p == ' ' || *p == '\t') && *p != sc) p++;
        if (p >= end) break;
        if (*p != sc) {
            err = std::string("unexpected character '") + *p + "' in " + filename + " row " +
                  std::to_string(row_index);
            return -1;
        }
        p++;
    }
    return cols;
}

std::string ragged_message(long row, long got, long expected) {
    return "Error: row " + std::to_string(row) + " has " + std::to_string(got) +
           " columns, but previous row(s) have " + std::to_string(expected) + " columns.";
}

struct Matrix {
    std::vector<double> data;
};

// ------------------------------------------------------------ chunk reader
struct ChunkState {
    std::unique_ptr<LineReader> lines;  // read by the worker alone
    std::mutex mu;
    std::condition_variable cv;
    std::thread worker;
    std::vector<double> ready;    // the chunk in flight, parsed ahead
    long ready_rows = 0;
    bool ready_valid = false;
    std::vector<double> current;  // the chunk handed out by the last next()
    long current_rows = 0;
    bool done = false;            // the worker reached the end or an error
    std::atomic<bool> stop{false};  // the consumer is closing the reader
    std::string error;            // raised once the queued chunk is taken
    long chunk_rows = 0;
    long ncols = -1;
    long row_index = 0;           // rows parsed so far, over all chunks
    char sep = ',';
    std::string filename;
};

void chunk_worker(ChunkState *st) {
    LineReader &lines = *st->lines;
    for (;;) {
        std::vector<double> buf;
        if (st->ncols > 0) buf.reserve(static_cast<size_t>(st->chunk_rows) * st->ncols);
        long rows = 0;
        std::string err;
        char *line;
        size_t len;
        while (rows < st->chunk_rows && !st->stop.load(std::memory_order_relaxed) &&
               lines.next(line, len)) {
            long cols = parse_line(line, len, st->sep, st->row_index, st->filename.c_str(),
                                   buf, err);
            if (cols < 0) break;
            if (st->ncols >= 0 && cols != st->ncols) {
                err = ragged_message(st->row_index, cols, st->ncols);
                break;
            }
            if (st->ncols < 0) st->ncols = cols;
            st->row_index++;
            rows++;
        }
        if (st->stop.load()) return;
        bool failed = !err.empty();
        bool eof = !failed && rows < st->chunk_rows;
        if (failed) {  // the partial chunk is dropped
            buf.clear();
            rows = 0;
        }
        if (!failed && rows == 0 && st->row_index == 0) {
            err = st->filename + " is empty";
            failed = true;
        }

        std::unique_lock<std::mutex> lk(st->mu);
        if (rows > 0) {  // one chunk in flight: wait until the last one was taken
            st->cv.wait(lk, [st] { return !st->ready_valid || st->stop.load(); });
            if (st->stop.load()) return;
            st->ready = std::move(buf);
            st->ready_rows = rows;
            st->ready_valid = true;
        }
        if (failed) st->error = err;
        if (failed || eof) st->done = true;
        st->cv.notify_all();
        if (st->done) return;
    }
}

}  // namespace

extern "C" {

// Parse a whole file.  Returns a handle and its shape, or null with the
// message in err and its kind; pio_matrix_take copies it out and frees it.
void *pio_read_matrix(const char *filename, char sep, long *rows, long *cols, char *err,
                      long errlen, int *kind) {
    std::FILE *f = std::fopen(filename, "r");
    if (f == nullptr) {
        set_error(err, errlen, std::string("cannot open ") + filename);
        *kind = PIO_OS;
        return nullptr;
    }
    LineReader lines(f);
    auto *m = new Matrix();
    long nrows = 0, ncols = -1;
    std::string msg;
    char *line;
    size_t len;
    while (lines.next(line, len)) {
        long c = parse_line(line, len, sep, nrows, filename, m->data, msg);
        if (c < 0) break;
        if (ncols >= 0 && c != ncols) {
            msg = ragged_message(nrows, c, ncols);
            break;
        }
        if (ncols < 0) {
            ncols = c;
            m->data.reserve(static_cast<size_t>(c) * 4096);
        }
        nrows++;
    }
    if (msg.empty() && nrows == 0) msg = std::string(filename) + " is empty";
    if (!msg.empty()) {
        delete m;
        set_error(err, errlen, msg);
        *kind = PIO_VALUE;
        return nullptr;
    }
    *rows = nrows;
    *cols = ncols;
    *kind = PIO_OK;
    return m;
}

// Copy the parsed matrix into out (rows × cols float64, row-major) unless
// out is null, then free it.
void pio_matrix_take(void *handle, double *out) {
    auto *m = static_cast<Matrix *>(handle);
    if (out != nullptr) std::copy(m->data.begin(), m->data.end(), out);
    delete m;
}

// Open a chunk reader and start its thread; null with err/kind on failure.
void *pio_chunk_open(const char *filename, long chunk_rows, char sep, char *err, long errlen,
                     int *kind) {
    std::FILE *f = std::fopen(filename, "r");
    if (f == nullptr) {
        set_error(err, errlen, std::string("cannot open ") + filename);
        *kind = PIO_OS;
        return nullptr;
    }
    auto *st = new ChunkState();
    st->lines = std::make_unique<LineReader>(f);
    st->filename = filename;
    st->chunk_rows = chunk_rows;
    st->sep = sep;
    g_live_readers++;
    st->worker = std::thread(chunk_worker, st);
    *kind = PIO_OK;
    return st;
}

// Wait for the next chunk.  Returns 1 with its shape (take it with
// pio_chunk_copy), 0 at the end, or -1 with the worker's error, which
// every later call returns again.
int pio_chunk_next(void *handle, long *rows, long *cols, char *err, long errlen) {
    auto *st = static_cast<ChunkState *>(handle);
    std::unique_lock<std::mutex> lk(st->mu);
    st->cv.wait(lk, [st] { return st->ready_valid || st->done; });
    if (st->ready_valid) {
        st->current.swap(st->ready);  // no copy: the buffers trade places
        st->current_rows = st->ready_rows;
        st->ready_valid = false;
        st->cv.notify_all();
        *rows = st->current_rows;
        *cols = st->ncols;
        return 1;
    }
    if (!st->error.empty()) {
        set_error(err, errlen, st->error);
        return -1;
    }
    return 0;
}

// Copy the chunk the last pio_chunk_next handed out into out.
void pio_chunk_copy(void *handle, double *out) {
    auto *st = static_cast<ChunkState *>(handle);
    std::copy(st->current.begin(), st->current.end(), out);
}

// Stop the worker, join it and free the reader, at any point.
void pio_chunk_close(void *handle) {
    auto *st = static_cast<ChunkState *>(handle);
    {
        std::lock_guard<std::mutex> lk(st->mu);
        st->stop.store(true);
        st->cv.notify_all();
    }
    if (st->worker.joinable()) st->worker.join();
    delete st;
    g_live_readers--;
}

// Chunk readers opened and not yet closed (their threads not yet joined).
long pio_live_readers() { return g_live_readers.load(); }

// reps × n: the index vector 0..n-1 shuffled by std::shuffle on one live
// std::mt19937, after each replicate (the vector is not reset).
void pio_gcc_shuffle_trace(unsigned long seed, long n, long reps, int64_t *out) {
    std::mt19937 rng(static_cast<std::mt19937::result_type>(seed));
    std::vector<int64_t> v(n);
    std::iota(v.begin(), v.end(), 0);
    for (long r = 0; r < reps; r++) {
        std::shuffle(v.begin(), v.end(), rng);
        std::copy(v.begin(), v.end(), out + r * n);
    }
}

// The first n raw draws of std::mt19937(seed).
void pio_mt19937_raw(unsigned long seed, long n, uint32_t *out) {
    std::mt19937 rng(static_cast<std::mt19937::result_type>(seed));
    for (long i = 0; i < n; i++) out[i] = static_cast<uint32_t>(rng());
}

}  // extern "C"
