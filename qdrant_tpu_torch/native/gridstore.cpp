// Page-based blob storage for payloads ("Gridstore" analogue).
//
// Reference behavior: lib/blobstore (Gridstore) — fixed-size pages divided
// into 128-byte blocks; each point id maps to (page, block, length); deletes
// free blocks for reuse; a tracker file persists the id -> location map.
// This implementation keeps the same shape with a single data file:
//
//   data file  = N pages x PAGE_SIZE, each page split into 128-byte blocks
//   tracker    = binary array of {u64 offset_bytes, u32 length} per point id
//                (offset == UINT64_MAX means "no payload")
//
// Values are stored contiguously (may span blocks within a page but not
// pages; values larger than a page get a dedicated run of whole pages).
// Free space is tracked as a block bitmap rebuilt from the tracker at open.
//
// C ABI for ctypes (see native/__init__.py): gs_open/gs_put/gs_get_len/
// gs_get/gs_delete/gs_flush/gs_close.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kBlock = 128;
constexpr uint64_t kPageBlocks = 256;                 // 32 KiB pages
constexpr uint64_t kPage = kBlock * kPageBlocks;
constexpr uint64_t kNoValue = UINT64_MAX;

struct Slot {
  uint64_t offset;  // byte offset into the data file
  uint32_t length;  // value length in bytes
};

struct Store {
  std::string dir;
  FILE* data = nullptr;
  std::vector<Slot> slots;          // indexed by point id (internal offset)
  std::vector<uint8_t> block_used;  // one flag per block
  uint64_t file_blocks = 0;

  std::string data_path() const { return dir + "/gridstore.bin"; }
  std::string tracker_path() const { return dir + "/gridstore.tracker"; }
};

uint64_t blocks_for(uint32_t len) { return (len + kBlock - 1) / kBlock; }

void mark(Store* s, uint64_t offset, uint32_t len, uint8_t used) {
  uint64_t first = offset / kBlock;
  uint64_t n = blocks_for(len);
  if (first + n > s->block_used.size()) s->block_used.resize(first + n, 0);
  for (uint64_t i = 0; i < n; i++) s->block_used[first + i] = used;
}

// First-fit run of free blocks that does not cross a page boundary (values
// larger than a page take whole pages, so their runs are page-aligned).
uint64_t find_run(Store* s, uint64_t need) {
  uint64_t total = s->block_used.size();
  if (need >= kPageBlocks) {
    // whole-page allocation, page aligned
    for (uint64_t start = 0; start + need <= total; start += kPageBlocks) {
      bool ok = true;
      for (uint64_t i = 0; i < need && ok; i++) ok = !s->block_used[start + i];
      if (ok) return start;
    }
    uint64_t start = (total + kPageBlocks - 1) / kPageBlocks * kPageBlocks;
    s->block_used.resize(start + need, 0);
    return start;
  }
  for (uint64_t start = 0; start + need <= total; start++) {
    if (start / kPageBlocks != (start + need - 1) / kPageBlocks) continue;
    bool ok = true;
    for (uint64_t i = 0; i < need && ok; i++) ok = !s->block_used[start + i];
    if (ok) return start;
  }
  uint64_t start = total;
  if (start / kPageBlocks != (start + need - 1) / kPageBlocks)
    start = (start + kPageBlocks - 1) / kPageBlocks * kPageBlocks;
  s->block_used.resize(start + need, 0);
  return start;
}

bool load_tracker(Store* s) {
  FILE* f = fopen(s->tracker_path().c_str(), "rb");
  if (!f) return true;  // fresh store
  uint64_t count = 0;
  if (fread(&count, sizeof(count), 1, f) != 1) {
    fclose(f);
    return true;
  }
  s->slots.resize(count);
  for (uint64_t i = 0; i < count; i++) {
    if (fread(&s->slots[i].offset, sizeof(uint64_t), 1, f) != 1 ||
        fread(&s->slots[i].length, sizeof(uint32_t), 1, f) != 1) {
      fclose(f);
      return false;
    }
    if (s->slots[i].offset != kNoValue)
      mark(s, s->slots[i].offset, s->slots[i].length, 1);
  }
  fclose(f);
  return true;
}

bool save_tracker(Store* s) {
  std::string tmp = s->tracker_path() + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return false;
  uint64_t count = s->slots.size();
  fwrite(&count, sizeof(count), 1, f);
  for (auto& slot : s->slots) {
    fwrite(&slot.offset, sizeof(uint64_t), 1, f);
    fwrite(&slot.length, sizeof(uint32_t), 1, f);
  }
  fflush(f);
  fclose(f);
  return rename(tmp.c_str(), s->tracker_path().c_str()) == 0;
}

}  // namespace

extern "C" {

void* gs_open(const char* dir) {
  auto* s = new Store();
  s->dir = dir;
  s->data = fopen(s->data_path().c_str(), "r+b");
  if (!s->data) s->data = fopen(s->data_path().c_str(), "w+b");
  if (!s->data || !load_tracker(s)) {
    if (s->data) fclose(s->data);
    delete s;
    return nullptr;
  }
  return s;
}

int gs_put(void* handle, uint64_t id, const uint8_t* buf, uint32_t len) {
  auto* s = static_cast<Store*>(handle);
  if (id >= s->slots.size()) s->slots.resize(id + 1, {kNoValue, 0});
  Slot& slot = s->slots[id];
  if (slot.offset != kNoValue) mark(s, slot.offset, slot.length, 0);
  if (len == 0) {
    slot = {kNoValue, 0};
    return 0;
  }
  uint64_t start_block = find_run(s, blocks_for(len));
  uint64_t offset = start_block * kBlock;
  if (fseek(s->data, (long)offset, SEEK_SET) != 0) return -1;
  if (fwrite(buf, 1, len, s->data) != len) return -1;
  slot = {offset, len};
  mark(s, offset, len, 1);
  return 0;
}

int64_t gs_get_len(void* handle, uint64_t id) {
  auto* s = static_cast<Store*>(handle);
  if (id >= s->slots.size() || s->slots[id].offset == kNoValue) return -1;
  return s->slots[id].length;
}

int gs_get(void* handle, uint64_t id, uint8_t* out, uint32_t cap) {
  auto* s = static_cast<Store*>(handle);
  if (id >= s->slots.size() || s->slots[id].offset == kNoValue) return -1;
  Slot& slot = s->slots[id];
  if (slot.length > cap) return -2;
  if (fseek(s->data, (long)slot.offset, SEEK_SET) != 0) return -1;
  if (fread(out, 1, slot.length, s->data) != slot.length) return -1;
  return (int)slot.length;
}

int gs_delete(void* handle, uint64_t id) {
  auto* s = static_cast<Store*>(handle);
  if (id >= s->slots.size() || s->slots[id].offset == kNoValue) return 0;
  mark(s, s->slots[id].offset, s->slots[id].length, 0);
  s->slots[id] = {kNoValue, 0};
  return 0;
}

uint64_t gs_count(void* handle) {
  auto* s = static_cast<Store*>(handle);
  uint64_t n = 0;
  for (auto& slot : s->slots)
    if (slot.offset != kNoValue) n++;
  return n;
}

uint64_t gs_capacity(void* handle) {
  return static_cast<Store*>(handle)->slots.size();
}

int gs_flush(void* handle) {
  auto* s = static_cast<Store*>(handle);
  fflush(s->data);
  return save_tracker(s) ? 0 : -1;
}

void gs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  fflush(s->data);
  save_tracker(s);
  fclose(s->data);
  delete s;
}

}  // extern "C"
