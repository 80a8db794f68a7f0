// Native WAL engine: segmented, length-prefixed records with CRC32.
//
// Drop-in binary-compatible with the Python WAL (storage/wal.py):
//   record = [u32 len][u32 crc32(payload)][payload bytes]
//   segment files: wal_%016d.log, first op_num encoded in the name.
// Reference behavior: lib/wal/ (segmented WAL) + lib/shard/src/wal.rs.
//
// C API surface (ctypes-friendly): open/append/sync/ack/close + a cursor
// based reader used for recovery replay.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <algorithm>
#include <sys/stat.h>
#include <sys/types.h>
#include <dirent.h>
#include <unistd.h>

namespace {

// ---- crc32 (IEEE, zlib-compatible) ---------------------------------------

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t crc32_buf(const uint8_t* buf, size_t len) {
    crc_init();
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---- segment bookkeeping --------------------------------------------------

struct Segment {
    uint64_t first_op;
    std::string filename;
};

struct Wal {
    std::string path;
    uint64_t segment_capacity;
    std::vector<Segment> segments;
    uint64_t next_op;
    FILE* open_file;
    uint64_t open_size;
};

std::string seg_path(const Wal* w, const std::string& name) {
    return w->path + "/" + name;
}

uint64_t file_size(const std::string& p) {
    struct stat st;
    if (stat(p.c_str(), &st) != 0) return 0;
    return (uint64_t)st.st_size;
}

// scan a segment file: count valid records, return valid byte size
void scan_segment(const std::string& p, uint64_t* count, uint64_t* valid_size) {
    *count = 0;
    *valid_size = 0;
    FILE* f = fopen(p.c_str(), "rb");
    if (!f) return;
    std::vector<uint8_t> buf;
    for (;;) {
        uint32_t header[2];
        if (fread(header, 1, 8, f) != 8) break;
        uint32_t len = header[0], crc = header[1];
        buf.resize(len);
        if (len > 0 && fread(buf.data(), 1, len, f) != len) break;
        if (crc32_buf(buf.data(), len) != crc) break;
        (*count)++;
        (*valid_size) += 8 + len;
    }
    fclose(f);
}

}  // namespace

extern "C" {

Wal* wal_open(const char* path, uint64_t segment_capacity) {
    Wal* w = new Wal();
    w->path = path;
    w->segment_capacity = segment_capacity;
    w->next_op = 1;
    w->open_file = nullptr;
    w->open_size = 0;
    mkdir(path, 0755);

    DIR* dir = opendir(path);
    if (dir) {
        std::vector<std::string> files;
        struct dirent* e;
        while ((e = readdir(dir)) != nullptr) {
            std::string name = e->d_name;
            if (name.rfind("wal_", 0) == 0 && name.size() > 8 &&
                name.substr(name.size() - 4) == ".log")
                files.push_back(name);
        }
        closedir(dir);
        std::sort(files.begin(), files.end());
        for (auto& f : files) {
            Segment s;
            s.first_op = strtoull(f.substr(4, 16).c_str(), nullptr, 10);
            s.filename = f;
            w->segments.push_back(s);
        }
        if (!w->segments.empty()) {
            auto& last = w->segments.back();
            uint64_t count, valid;
            std::string full = seg_path(w, last.filename);
            scan_segment(full, &count, &valid);
            if (valid < file_size(full)) {
                // truncate torn tail writes
                if (truncate(full.c_str(), (off_t)valid) != 0) { /* best effort */ }
            }
            w->next_op = last.first_op + count;
        }
    }
    return w;
}

uint64_t wal_next_op(Wal* w) { return w->next_op; }

// append a record; returns its op_num (0 on failure)
uint64_t wal_append(Wal* w, const uint8_t* payload, uint32_t len) {
    uint64_t op = w->next_op;
    if (w->open_file == nullptr || w->open_size >= w->segment_capacity) {
        if (w->open_file) fclose(w->open_file);
        char name[64];
        snprintf(name, sizeof(name), "wal_%016llu.log", (unsigned long long)op);
        Segment s;
        s.first_op = op;
        s.filename = name;
        w->segments.push_back(s);
        std::string full = seg_path(w, name);
        w->open_file = fopen(full.c_str(), "ab");
        if (!w->open_file) return 0;
        w->open_size = file_size(full);
    }
    uint32_t header[2] = {len, crc32_buf(payload, len)};
    if (fwrite(header, 1, 8, w->open_file) != 8) return 0;
    if (len > 0 && fwrite(payload, 1, len, w->open_file) != len) return 0;
    fflush(w->open_file);
    w->open_size += 8 + len;
    w->next_op++;
    return op;
}

void wal_sync(Wal* w) {
    if (w->open_file) {
        fflush(w->open_file);
        fsync(fileno(w->open_file));
    }
}

// drop whole segments entirely below the ack point (keep the last one)
void wal_ack(Wal* w, uint64_t op_num) {
    std::vector<Segment> keep;
    for (size_t i = 0; i < w->segments.size(); i++) {
        uint64_t next_first = (i + 1 < w->segments.size())
                                  ? w->segments[i + 1].first_op
                                  : w->next_op;
        if (next_first - 1 <= op_num && i + 1 < w->segments.size()) {
            remove(seg_path(w, w->segments[i].filename).c_str());
        } else {
            keep.push_back(w->segments[i]);
        }
    }
    w->segments = keep;
}

void wal_close(Wal* w) {
    if (w->open_file) fclose(w->open_file);
    delete w;
}

// ---- reader cursor --------------------------------------------------------

struct WalCursor {
    Wal* wal;
    size_t seg_idx;
    FILE* f;
    uint64_t op_num;
    uint64_t from;
    std::vector<uint8_t> buf;
};

WalCursor* wal_read_from(Wal* w, uint64_t from_op) {
    if (w->open_file) fflush(w->open_file);
    WalCursor* c = new WalCursor();
    c->wal = w;
    c->seg_idx = 0;
    c->f = nullptr;
    c->op_num = 0;
    c->from = from_op;
    return c;
}

// → payload length (>=0) with *op_num set; -1 = end of log
int64_t wal_cursor_next(WalCursor* c, uint64_t* op_num) {
    Wal* w = c->wal;
    for (;;) {
        if (c->f == nullptr) {
            if (c->seg_idx >= w->segments.size()) return -1;
            uint64_t next_first = (c->seg_idx + 1 < w->segments.size())
                                      ? w->segments[c->seg_idx + 1].first_op
                                      : w->next_op;
            if (next_first <= c->from) {  // fully before the replay point
                c->seg_idx++;
                continue;
            }
            c->f = fopen(seg_path(w, w->segments[c->seg_idx].filename).c_str(), "rb");
            c->op_num = w->segments[c->seg_idx].first_op;
            if (c->f == nullptr) {
                c->seg_idx++;
                continue;
            }
        }
        uint32_t header[2];
        if (fread(header, 1, 8, c->f) != 8) {
            fclose(c->f);
            c->f = nullptr;
            c->seg_idx++;
            continue;
        }
        uint32_t len = header[0], crc = header[1];
        c->buf.resize(len);
        if (len > 0 && fread(c->buf.data(), 1, len, c->f) != len) {
            fclose(c->f);
            c->f = nullptr;
            c->seg_idx++;
            continue;
        }
        if (crc32_buf(c->buf.data(), len) != crc) {
            fclose(c->f);
            c->f = nullptr;
            c->seg_idx++;
            continue;
        }
        uint64_t this_op = c->op_num++;
        if (this_op < c->from) continue;
        *op_num = this_op;
        return (int64_t)len;
    }
}

const uint8_t* wal_cursor_payload(WalCursor* c) { return c->buf.data(); }

void wal_cursor_close(WalCursor* c) {
    if (c->f) fclose(c->f);
    delete c;
}

}  // extern "C"
